"""The camformer speculative tensor-parallel serving case and the
``model``-split train step over 4 gloo processes, against the port's
tp = 1 and the JAX package (the other serving cases, the launchers and
the gateway are in ``tests/test_torch_tp.py``; its helpers are
shared).

One module-scoped run starts 4 processes of ``tests/torch_tp_worker.py``
(part ``spec_train``; a file rendezvous under tmp_path, no TCP port;
killed after 300 s), and the tests below hold what they wrote:

  * camformer with spec_k = 4 and a 12-token shared prefix (COW) at
    tp = 2 in sync and overlap mode: every process's events, readbacks
    and ticks equal the port's tp = 1 and the JAX tp = 1 run's, a plan
    compared every tick, 1/2 of the pool bytes on each process;
  * the train step on make_mesh_for(4, 2) under the tp profile, split
    over ``model`` (camformer-bert smoke: ``heads``; granite smoke with 8
    padded experts: ``qheads`` and the experts split), from the JAX
    package's initial state: 3 steps' metrics within 1e-5 of the JAX
    single-device step and every leaf's step-1 gradient within 1e-4
    (``_check_train`` of ``tests/test_torch_distributed.py``); each
    process ran its attention on H / 2 heads, its MLP on d_ff / 2
    columns, half the vocabulary and half the experts, and no parameter
    split along ``model`` in storage was gathered whole but those the
    strategy needs whole.
"""

import functools

import pytest

from repro.train import checkpoint as j_ckpt

from test_torch_distributed import _check_train, _initial, _reference_train
from test_torch_tp import _jax_identity, _jax_params, jax_runs, same_as, \
    tp1, write_params
from torch_tp_worker import TRAIN_PART_CASES, run_ranks

TRAIN = ("camformer", "granite")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_train")
    params = _jax_params()
    write_params(out, params)
    for name in TRAIN:  # the train step's initial states
        j_ckpt.save_checkpoint(str(out / f"jax_{name}"), _initial(name), 0)

    def during():  # the JAX package's runs while the processes run
        runs = {name: functools.partial(_jax_identity, params, name)
                for name in TRAIN_PART_CASES}
        runs.update({name: functools.partial(_reference_train, name)
                     for name in TRAIN})
        return jax_runs(runs)

    refs, res = run_ranks(out, "spec_train", during)
    return res, refs


@pytest.mark.parametrize("name", TRAIN_PART_CASES)
@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_tp2_spec_streams_equal_tp1_and_the_reference(ranks, name, mode):
    res, refs = ranks
    want = tp1(res, f"{name}/{mode}")
    for r in res[:2]:
        same_as(r["serving"][f"{name}/{mode}"], want, refs[name], 2, mode)


# what each case's processes ran on: H / 2 heads, d_ff / 2 columns, half
# the (padded) vocabulary, half the padded experts, half the residual
# stream's 64 rows (res_seq); granite's single kv head is whole, one copy
# for each of the two local q heads
SPLIT = {"camformer": dict(attn_q_heads=2, attn_kv_heads=2, mlp_cols=48,
                           vocab_rows=128, res_rows=32),
         "granite": dict(attn_q_heads=2, attn_kv_heads=2, experts=4,
                         vocab_rows=128, res_rows=32)}
WHOLE_ALONG_MODEL = {"camformer": set(), "granite": {"wk", "wv", "router"}}


@pytest.mark.parametrize("name", TRAIN)
def test_model_split_step_matches_single_device(ranks, name):
    res, refs = ranks
    _check_train(res, name, refs[name])
    for r in res:
        got = r["train"][name]
        assert got["seen"] == SPLIT[name]
        # leaves split along model in storage but gathered whole
        whole = {k for k, on_model, how in got["leaves"]
                 if on_model and how != "split"}
        assert whole == WHOLE_ALONG_MODEL[name], whole
        assert any(how == "split" for _, _, how in got["leaves"])
