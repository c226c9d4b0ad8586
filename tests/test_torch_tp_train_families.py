"""The ``model``-split train step of the encoder-decoder, Griffin hybrid
and RWKV-6 families over 4 gloo processes, against the JAX package's
single-device step.

One module-scoped run starts 4 processes of ``tests/torch_tp_worker.py``
(part ``families``; a file rendezvous under tmp_path, no TCP port;
killed after 300 s) while this process runs the JAX package's steps.
Each case trains 3 steps on make_mesh_for(4, 2) under the tp profile
(rows over ``data``, the compute split over ``model``) from the JAX
package's initial state: every metric within 1e-5 of the reference's
and every leaf's step-1 gradient within 1e-4 (``_check_train`` of
``tests/test_torch_distributed.py``); ``SPLIT_SEEN`` holds what each
process ran on, and no parameter split along ``model`` in storage was
gathered whole but those the plan needs whole:

  * whisper-medium smoke: 2 of 4 heads in the encoder's self-attention
    and the decoder's self- and cross-attention, 48 of 96 MLP columns;
  * recurrentgemma-2b smoke: 32 of 64 rnn channels, MQA 4 on 1 as
    ``qheads`` (2 q heads, the kv head whole: ``wk``/``wv`` summed over
    ``model``), the GeGLU MLP's 48 columns;
  * rwkv6-3b smoke with ``rwkv_head_dim=16``: 2 of 4 time-mix heads, 48
    of 96 channel-mix columns;
  * rwkv6-3b smoke (one head of 64): the resolver would cut inside the
    head, so the time mix runs whole (gathered whole) and the channel
    mix splits.

The one-head rwkv6 case is held step by step: its step 1 as above, and
steps 2 and 3 against the JAX step run from the parameters this run
started them from (``reference_from``), each metric within 1e-5.  Its
trajectory leaves the reference's after step 1: the split's summation
order (the channel mix's two partial products) changes the sign of two
step-1 gradient components whose magnitudes, 1.6e-7 and 2.9e-8, are
1.6e-5 and 8e-7 of their leaves' largest (``cm.wr``, ``tm.wk``).
AdamW's first update is lr x sign(g) for every component above its eps,
so those two weights move by 2 lr the other way, and step 2's gradient
norm by 2.1e-5 relative; the loss and ce stay within 5e-7.  Any
reordering of sums can do this (the four-head case's one flip is below
eps), so a per-step comparison is what tests the step there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.launch.steps import make_train_step as j_train_step
from repro.models import get_model_def as j_model_def
from repro.train import checkpoint as j_ckpt

from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.train.data import SyntheticLMData as TData

from test_torch_distributed import _check_train, _jax_array, \
    initial_state, reference_train
from test_torch_tp import jax_runs
from torch_tp_worker import FAMILY_CASES, run_ranks

PER_STEP = {"rwkv6"}  # held step by step (see the module doc)


def start(tmp_path_factory, part, cases):
    """Every rank's results and the JAX package's runs of ``cases``."""
    out = tmp_path_factory.mktemp(part)
    for name, arch, over, _, _ in cases:  # the initial states
        j_ckpt.save_checkpoint(str(out / f"jax_{name}"),
                               initial_state(arch, over), 0)
    runs = {name: functools.partial(reference_train, arch, over,
                                    _shape(seq_len))
            for name, arch, over, _, seq_len in cases}
    refs, res = run_ranks(out, part, lambda: jax_runs(runs))
    for name, arch, over, _, seq_len in cases:
        if name in PER_STEP:
            refs[name + "/from"] = reference_from(
                arch, over, _shape(seq_len),
                res[0]["train"][name]["params_at"])
    return res, refs


def _shape(seq_len):
    """The name of the 8-row train input shape of ``seq_len`` tokens."""
    name = f"dist_tiny{seq_len}"
    T_SHAPES[name] = dict(seq_len=seq_len, global_batch=8, kind="train")
    return name


def reference_from(arch, over, shape, params_at):
    """The JAX package's single-device step k >= 1 on batch k, from the
    parameters ``params_at[k - 1]`` (its AdamW moments and step count
    the reference's own at k: the metrics read the parameters and the
    step count only): each step's metrics."""
    tcfg, jcfg = t_smoke(arch, **over), j_smoke(arch, **over)
    step = jax.jit(j_train_step(j_model_def(jcfg), jcfg, warmup=1)[0])
    state = initial_state(arch, over)
    data = TData(tcfg, shape, seed=1, device="cpu")
    out = []
    for i in range(len(params_at) + 1):
        batch = {k: _jax_array(v) for k, v in data.batch(i).items()}
        if i:
            params = jax.tree.map(lambda t: jnp.asarray(np.asarray(t)),
                                  params_at[i - 1])
            out.append({k: float(v) for k, v in step(
                dict(state, params=params), batch)[1].items()})
        state, _ = step(state, batch)
    return out


def check_case(ranks, name, seen, whole_along_model):
    res, refs = ranks
    if name in PER_STEP:  # step 1 as _check_train, the later ones forced
        want, m1 = refs[name]
        first = [{"train": {name: dict(r["train"][name],
                                       metrics=r["train"][name]["metrics"]
                                       [:1])}} for r in res]
        _check_train(first, name, (want[:1], m1))
        got = res[0]["train"][name]["metrics"]
        for step, (g, w) in enumerate(zip(got[1:], refs[name + "/from"])):
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), \
                    (name, step + 1, k, g[k], w[k])
    else:
        _check_train(res, name, refs[name])
    for r in res:
        got = r["train"][name]
        assert got["seen"] == seen, got["seen"]
        # leaves split along model in storage but gathered whole
        whole = {k for k, on_model, how in got["leaves"]
                 if on_model and how != "split"}
        assert whole == whole_along_model, whole


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return start(tmp_path_factory, "families", FAMILY_CASES)


TM = {"wr", "wk", "wv", "wg", "wo"}  # the time mix's head-split leaves
CASES = {
    "whisper": (dict(attn_q_heads=2, attn_kv_heads=2, mlp_cols=48,
                     vocab_rows=128), set()),
    "recurrentgemma": (dict(rnn=32, attn_q_heads=2, attn_kv_heads=2,
                            mlp_cols=48, vocab_rows=128), {"wk", "wv"}),
    "rwkv6_4_heads": (dict(tm_heads=2, cm_cols=48, vocab_rows=128), set()),
    # one head of 64: the resolver splits its 64 columns, the plan keeps
    # the time mix whole (``u``'s single row is not split in storage)
    "rwkv6": (dict(tm_whole_heads=1, cm_cols=48, vocab_rows=128), TM),
}


@pytest.mark.parametrize("name", [c[0] for c in FAMILY_CASES])
def test_family_model_split_step_matches_single_device(ranks, name):
    seen, whole = CASES[name]
    check_case(ranks, name, seen, whole)
