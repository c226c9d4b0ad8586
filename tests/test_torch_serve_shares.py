"""Share mode of the port's sharded serving steps
(``launch.steps.serve_shares``): every rank's share of a ``model``
split of 2 or 4 in turn in this process, at f32 smoke width, for the
encoder-decoder (whisper-medium: its heads split, the encoder memory a
cache leaf every rank reads whole) and RWKV-6 (rwkv6-3b with 4 heads:
its WKV state's heads split) families and camformer-bert with 6 heads
at 4 (``q_seq`` prefill, each decode step's attention whole on the
projections' gathered columns, the cache's sequence split over
``model``): a 16-token prompt and 8 greedy steps, each step's logits
within 1e-5 of max |logits| of the unsplit port step's and 1e-4 of
the JAX package's unsharded ``make_prefill_step`` /
``make_serve_step`` on the same weights (``from_jax_params``), the
picks identical, and the caches against the reference's as in
``tests/test_torch_serve_split.py`` (float leaves 1e-5, packed keys
and integer leaves bit-exact).
"""

import numpy as np
import pytest
import torch

from repro_torch.launch import steps as S
from repro_torch.models import get_model_def, init_pools

from test_torch_serve_split import (CACHE_LEN, PROMPT_LEN, STEPS,
                                    _close_caches, _prompt, _setup,
                                    reference)


SHARE_CASES = (  # (name, arch, overrides, model, batch, extra inputs)
    ("whisper", "whisper-medium", {}, 2, 2, "audio"),
    ("rwkv6", "rwkv6-3b", dict(rwkv_head_dim=16), 2, 2, None),
    ("camformer_m4", "camformer-bert",
     dict(attn_backend="camformer", n_heads=6, n_kv_heads=6), 4, 2, None),
)


@pytest.mark.parametrize("case", SHARE_CASES, ids=lambda c: c[0])
def test_shares_match_the_unsplit_step_and_the_reference(case):
    """Every rank's share of the sharded steps in turn in one process
    against the unsplit port step and the reference (module doc)."""
    name, arch, over, model, batch, extra = case
    jc, tc, _, _, tp = _setup(arch, over)
    feed = {}
    if extra == "audio":
        rng = np.random.default_rng(2)
        feed["audio_features"] = rng.standard_normal(
            (batch, tc.enc_len, tc.d_model)).astype(np.float32)
    want = reference(arch, over, batch, feed)
    md = get_model_def(tc)
    whole = init_pools(md.cache_specs(tc, batch, CACHE_LEN), "cpu")
    split = init_pools(md.cache_specs(tc, batch, CACHE_LEN), "cpu")
    batch_t = {"tokens": torch.from_numpy(_prompt(jc, batch)),
               **{k: torch.from_numpy(v) for k, v in feed.items()}}
    plain = S.make_prefill_step(md, tc)(tp, batch_t, whole)[0]
    outs = S.serve_shares(md, tc, "prefill", tp, (batch_t,), split, model)
    for step in range(STEPS + 1):
        got = torch.cat(outs, -1) if outs[0].shape[-1] < plain.shape[-1] \
            else outs[0]
        assert (got - plain).abs().max() <= 1e-5 * plain.abs().max(), step
        np.testing.assert_allclose(got.numpy(), want["logits"][step],
                                   rtol=1e-4, atol=1e-4)
        if step == STEPS:
            break
        tok = plain.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want["tokens"][step])
        assert torch.equal(got.argmax(-1).to(torch.int32), tok)
        pos = torch.full((batch,), PROMPT_LEN + step, dtype=torch.int32)
        plain = S.make_serve_step(md, tc)(tp, tok, pos, pos + 1, whole)[0]
        outs = S.serve_shares(md, tc, "decode", tp, (tok, pos, pos + 1),
                              split, model)
    _close_caches(split, want["caches"])
