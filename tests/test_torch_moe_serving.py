"""The MoE family through the port's ``ServeEngine`` against the JAX
engine on the same weights (f32 smoke ``granite-moe-3b-a800m`` at its
G = 3, 6 heads on 2 kv heads; CPU, 4 slots).

  * greedy token streams on ``dense`` and ``camformer``, in sync and
    overlap mode, equal the JAX engine's (sync: plain decode plans the
    same batches in both modes), with its ticks and one readback per
    tick;
  * self-speculative decoding (``spec_k=2``, a ``binary`` drafter sharing
    the MoE weights) gives the JAX engine's spec streams, in sync and
    overlap mode;
  * with a capacity that cannot drop a token (``capacity_factor`` =
    E / k, so cap = the group size), the spec stream equals plain decode.
    At granite's 1.25 it need not, in the reference as in the port: a
    token's output depends on the other tokens of its dispatch group
    through the capacity drops (padding and inert rows route too), and a
    verify chunk (B * m tokens) or an overlap spec tick groups other
    tokens than a decode step does;
  * the engine refuses the families without a ported model by name, and
    speculation on the VLM, whose model gives no verify pass (as in the
    reference).
"""

import pytest

from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.serving import ServeEngine
from torch_engine_runs import jax_run, tokens, torch_run

ARCH = "granite-moe-3b-a800m"
G3 = dict(n_heads=6, n_kv_heads=2)


@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_moe_streams_equal_reference(backend, mode):
    params_np, jreqs, jc = jax_run(ARCH, backend, **G3)
    eng, treqs = torch_run(ARCH, backend, params_np, mode, **G3)
    assert tokens(treqs) == tokens(jreqs)
    assert [r.prefix_matched for r in treqs] == \
        [r.prefix_matched for r in jreqs]
    assert eng.ticks == jc["ticks"]
    assert eng.readbacks == jc["readbacks"] == eng.ticks + eng.prefill_ticks


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_moe_spec_streams_equal_reference(mode):
    params_np, jreqs, jc = jax_run(ARCH, "dense", spec_k=2, mode=mode, **G3)
    eng, treqs = torch_run(ARCH, "dense", params_np, mode, spec_k=2, **G3)
    assert tokens(treqs) == tokens(jreqs)
    for name in ("ticks", "readbacks", "spec_proposed", "spec_accepted"):
        assert getattr(eng, name) == jc[name], name
    assert eng.spec_proposed > 0


def test_moe_spec_stream_equals_plain_decode_without_drops():
    cfg = smoke_config(ARCH)
    no_drop = dict(G3, capacity_factor=cfg.n_experts
                   / cfg.experts_per_token)
    params_np, _, _ = jax_run(ARCH, "dense", **G3)  # the same leaves
    _, plain = torch_run(ARCH, "dense", params_np, "overlap", **no_drop)
    eng, spec = torch_run(ARCH, "dense", params_np, "overlap", spec_k=2,
                          **no_drop)
    assert tokens(spec) == tokens(plain)
    assert eng.spec_proposed > 0
    assert eng.readbacks == eng.ticks + eng.prefill_ticks


@pytest.mark.parametrize("arch,family,error,match", [
    # ported, but with no paged interface, as in the reference
    ("rwkv6-3b", "ssm", ValueError, "paged serving interface"),
    ("recurrentgemma-2b", "hybrid", ValueError, "paged serving interface"),
    ("whisper-medium", "audio", ValueError, "paged serving interface")])
def test_engine_refuses_unported_families(arch, family, error, match):
    cfg = smoke_config(arch)
    with pytest.raises(error, match=f"family '{family}'.*{match}"):
        ServeEngine(cfg, {}, device="cpu")


def test_engine_refuses_speculation_on_the_vlm():
    cfg = smoke_config("llava-next-mistral-7b")
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="verify_paged"):
        ServeEngine(cfg, params, spec_k=2, device="cpu")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, page_size=8,
                      device="cpu")  # text-only serving
    assert eng.md.verify_paged is None
