"""The port's distribution over 4 gloo processes against the JAX package
(the port's counterpart of ``tests/test_distributed.py``).

One module-scoped run starts 4 processes of ``tests/torch_dist_worker.py``
(a file rendezvous under tmp_path, no TCP port; killed after
``TIMEOUT_S``); each writes what it saw, and the tests below hold it, in
this process, against the JAX package on one device:

  * the sharded train step on make_mesh_for(4, 2) (tp profile: rows over
    ``data``, blocks over ``data`` and ``model``; dp profile: rows and
    the embed axis over both) at 8 x 64 tokens, from
    the JAX package's initial state (a JAX checkpoint restored onto the
    mesh), for
    granite MoE smoke (8 experts, the reference's case) and camformer-bert
    smoke: every metric of 3 steps within 1e-5 of the reference's
    single-device ``make_train_step`` (a larger error means a per-rank
    statistic, e.g. the aux loss or the token count, where the global
    one belongs), AdamW's m after step 1 within 1e-4 / (1 - b1) of the
    reference's (the clipped step-1 gradients), and blocks held by two
    processes bit-identical; one step with ``accum=2`` against the
    reference's;
  * elastic restore: a checkpoint saved on (2, 2) restored onto (4, 1)
    bit-identical, read back by the JAX package, and a JAX-written
    checkpoint restored onto (2, 2), each block the JAX array's slice;
  * the pipeline (4 stages, 5 microbatches) against the sequential
    oracle at 1e-5; the compressed psum against ``compressed_mean_ref``
    at 1e-4, its 60-step average within 0.05 of the true mean;
  * the distributed CAM search on (2, 2) within 1e-4 of the JAX
    package's ``_cache_attend`` and 1e-5 of the port's, directly and
    through ``decode`` with a write into the third shard;
  * ``launch.train.main`` with ``--devices 4 --model-parallel 2``.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import bacam as j_bacam
from repro.core import sign_pm1 as j_sign
from repro.core.backend import get_backend as j_backend
from repro.launch.steps import make_train_step as j_train_step
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init
from repro.models.module import tree_axes
from repro.sharding.compression import compressed_mean_ref
from repro.sharding.partitioning import PARAM_RULES, tree_pspecs
from repro.train import checkpoint as j_ckpt

from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.train.data import SyntheticLMData as TData

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 300
TRAIN_CASES = {"granite": ("granite-moe-3b-a800m", dict(n_experts_padded=8)),
               "camformer": ("camformer-bert", dict(attn_backend="camformer"))}
T_SHAPES["dist_tiny"] = dict(seq_len=64, global_batch=8, kind="train")
MESH_22 = {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(directory, every rank's results, the JAX package's train runs);
    the JAX checkpoints are written before the processes start."""
    out = tmp_path_factory.mktemp("dist")
    cfg = j_smoke("codeqwen1.5-7b")
    p = j_init(j_model_def(cfg).specs(cfg), jax.random.PRNGKey(0))
    m = jax.tree.map(lambda a: a * 0.5, p)
    j_ckpt.save_checkpoint(str(out / "jax_ckpt"), {
        "params": p, "opt": {"m": m, "v": p, "step": jnp.int32(7)}}, 7)
    for name in TRAIN_CASES:  # the train step's initial states
        j_ckpt.save_checkpoint(str(out / f"jax_{name}"), _initial(name), 0)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [e for e in [os.environ.get("PYTHONPATH")]
                               if e]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
         str(r), str(WORLD), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(WORLD)]
    try:
        # the JAX package's runs while the processes run
        refs = {name: _reference_train(name) for name in TRAIN_CASES}
        refs["accum2"] = _reference_accum2()
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)], refs


def _coords(rank, sizes):
    """Row-major mesh coordinates of ``rank``."""
    out = {}
    for name in reversed(list(sizes)):
        out[name] = rank % sizes[name]
        rank //= sizes[name]
    return out


def _block(full, spec, coords, sizes):
    """The reference spec's block of ``full`` at mesh ``coords``."""
    idx = []
    for dim, entry in zip(full.shape, tuple(spec) + (None,) * full.ndim):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, k = 1, 0
        for a in axes:
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        idx.append(slice(k * dim // n, (k + 1) * dim // n))
    return full[tuple(idx[:full.ndim])]


def _jax_leaf(tree, path):
    """The stacked JAX leaf and the layer index of a port path
    ("params/blocks/3/attn/wq")."""
    node, layer = tree, None
    for part in path.split("/"):
        if part.isdigit():
            layer = int(part)
        else:
            node = node[part]
    return node, layer


def _initial(name):
    """The JAX package's initial train state of a train case."""
    return initial_state(*TRAIN_CASES[name])


def initial_state(arch, over):
    """The JAX package's initial train state of ``arch``'s smoke config
    with ``over``."""
    jcfg = j_smoke(arch, **over)
    md = j_model_def(jcfg)
    params = j_init(md.specs(jcfg), jax.random.PRNGKey(0))
    _, opt = j_train_step(md, jcfg, warmup=1)
    return {"params": params, "opt": opt.init(params)}


def _reference_train(name):
    """The JAX package's single-device step from ``_initial`` on the
    global batch: 3 steps' metrics and m after step 1."""
    return reference_train(*TRAIN_CASES[name])


def reference_train(arch, over, shape="dist_tiny"):
    """``_reference_train`` of ``arch``'s smoke config with ``over`` (on
    the batches of the input shape ``shape``)."""
    tcfg, jcfg = t_smoke(arch, **over), j_smoke(arch, **over)
    step, _ = j_train_step(j_model_def(jcfg), jcfg, warmup=1)
    step = jax.jit(step)
    state = initial_state(arch, over)
    data = TData(tcfg, shape, seed=1, device="cpu")
    metrics, m1 = [], None
    for i in range(3):
        batch = {k: _jax_array(v) for k, v in data.batch(i).items()}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            m1 = jax.tree.map(np.asarray, state["opt"]["m"])
    return metrics, m1


def _jax_array(t):
    """A port batch tensor as a JAX array of the same dtype and values
    (bfloat16 through float32, which holds it exactly)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _reference_accum2():
    """The JAX package's first camformer step with ``accum=2``."""
    arch, over = TRAIN_CASES["camformer"]
    tcfg, jcfg = t_smoke(arch, **over), j_smoke(arch, **over)
    step, _ = j_train_step(j_model_def(jcfg), jcfg, warmup=1, accum=2)
    batch = {k: jnp.asarray(v.numpy()) for k, v in TData(
        tcfg, "dist_tiny", seed=1, device="cpu").batch(0).items()}
    return {k: float(v) for k, v in
            jax.jit(step)(_initial("camformer"), batch)[1].items()}


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_sharded_train_step_matches_single_device(ranks, name):
    _, res, refs = ranks
    # tp profile on (2, 2): rows over data, 4 rows a process
    assert [r["train"][name]["rows"] for r in res] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
    _check_train(res, name, refs[name])


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_dp_profile_train_step_matches_single_device(ranks, name):
    """The dp profile on (2, 2): rows over (data, model), 2 a process,
    and the embed axis of the blocks over both, so every gradient is
    reduced over every axis."""
    _, res, refs = ranks
    assert [r["train"]["dp_" + name]["rows"] for r in res] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    _check_train(res, "dp_" + name, refs[name])


def _check_train(res, key, ref):
    """Every process's metrics of ``res[r]["train"][key]`` the same, and
    within 1e-5 of the reference's; step 1's m within 1e-4 / (1 - b1)."""
    want, m1 = ref
    got = res[0]["train"][key]
    for r in res[1:]:
        assert r["train"][key]["metrics"] == got["metrics"]
    for step, (g, w) in enumerate(zip(got["metrics"], want)):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), \
                (key, step, k, g[k], w[k])
    flat_g = jax.tree_util.tree_leaves_with_path(got["grads1"])
    flat_w = dict(jax.tree_util.tree_leaves_with_path(m1))
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        err = np.abs(np.asarray(g) - flat_w[path]).max() / (1 - 0.9)
        assert err < 1e-4, (key, jax.tree_util.keystr(path), err)


def test_sharded_step_with_accumulation(ranks):
    """``accum=2`` under the mesh: each process cuts its rows in two, so
    microbatch i is every process's i-th half (rows 0, 1, 4, 5 and then
    2, 3, 6, 7, where the reference takes 0-3 and 4-7); with every token
    counted the mean of the two microbatch means is the global mean, the
    reference's loss and gradient norm within 1e-5."""
    _, res, refs = ranks
    want = refs["accum2"]
    for r in res:
        got = r["train"]["accum2"]
        assert got == res[0]["train"]["accum2"]
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), \
                (k, got[k], want[k])


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_replicated_blocks_identical_across_ranks(ranks, name):
    _, res, _ = ranks
    seen = {}
    for rank, r in enumerate(res):
        coords = _coords(rank, MESH_22)
        for path, (block, sharded) in r["train"][name]["blocks"].items():
            key = (path, tuple(list(coords.values())[i] for i in sharded))
            if key in seen:
                np.testing.assert_array_equal(block, seen[key])
            seen[key] = block
    # every leaf's blocks tile it: a replicated leaf is one block
    assert len(seen) < WORLD * len(res[0]["train"][name]["blocks"])


def test_elastic_rescale_bit_identical(ranks):
    out, res, _ = ranks
    for r in res:
        assert r["train"]["rescale"]["step"] == 3
        assert r["train"]["rescale"]["same"] is True
    # (4, 1): data takes 4 ways what (2, 2) split 2 x 2
    saved = res[0]["train"]["saved_state"]
    tmpl = jax.tree.map(np.asarray, saved)
    restored, step = j_ckpt.restore_checkpoint(str(out / "ckpt_22"), tmpl)
    assert step == 3
    for (p, a), b in zip(jax.tree_util.tree_leaves_with_path(restored),
                         jax.tree.leaves(saved)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(p))


def test_jax_checkpoint_restores_onto_the_mesh(ranks):
    out, res, _ = ranks
    cfg = j_smoke("codeqwen1.5-7b")
    specs = j_model_def(cfg).specs(cfg)
    shapes = jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape,
                                                         jnp.float32),
                          specs, is_leaf=lambda x: hasattr(x, "axes"))
    mesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    pspec = tree_pspecs(tree_axes(specs), shapes, mesh, PARAM_RULES)
    state, _ = j_ckpt.restore_checkpoint(str(out / "jax_ckpt"), {
        "params": shapes, "opt": {"m": shapes, "v": shapes,
                                  "step": jax.ShapeDtypeStruct((),
                                                               jnp.int32)}})
    n = 0
    for rank, r in enumerate(res):
        assert r["jax_ckpt"]["step"] == 7
        coords = _coords(rank, MESH_22)
        for path, (block, _) in r["jax_ckpt"]["blocks"].items():
            full, layer = _jax_leaf(state, path)
            spec, _ = _jax_leaf({"params": pspec, "opt": {
                "m": pspec, "v": pspec}}, path)
            full = np.asarray(full)
            if layer is not None:
                full, spec = full[layer], tuple(spec)[1:]
            np.testing.assert_array_equal(
                block, _block(full, spec, coords, MESH_22), err_msg=path)
            n += 1
    assert n > 0


def test_pipeline_matches_sequential(ranks):
    _, res, _ = ranks
    rng = np.random.default_rng(0)
    ws = jnp.asarray((rng.standard_normal((4, 16, 16)) / 16**0.5)
                     .astype(np.float32))
    ref = jnp.asarray(rng.standard_normal((5, 3, 16)).astype(np.float32))
    for s in range(4):
        ref = jnp.tanh(ref @ ws[s])
    for r in res:
        assert np.abs(r["pipeline"] - np.asarray(ref)).max() < 1e-5


def test_compressed_psum_matches_reference(ranks):
    _, res, _ = ranks
    g = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    ref_mean, _ = compressed_mean_ref(jnp.asarray(g), jnp.zeros((4, 64)))
    for r in res:
        np.testing.assert_allclose(r["compression"]["first"],
                                   res[0]["compression"]["first"], atol=1e-5)
        assert np.abs(r["compression"]["first"]
                      - np.asarray(ref_mean)).max() < 1e-4
        drift = np.abs(r["compression"]["avg"] - g.mean(0)).max()
        assert drift < 0.05, drift


def _cam_case():
    """The JAX side of the worker's ``cam_part``: (cfg, q, cache, k_new,
    v_new), drawn in the same order from the same seed."""
    rng = np.random.default_rng(3)
    draw = lambda shape: jnp.asarray(rng.standard_normal(shape),
                                     jnp.float32)
    k_raw, v = draw((1, 2, 64, 128)), draw((1, 2, 64, 128))
    q, k_new, v_new = draw((1, 4, 1, 128)), draw((1, 2, 1, 128)), draw(
        (1, 2, 1, 128))
    cfg = j_smoke("codeqwen1.5-7b", head_dim=128, n_heads=4,
                  n_kv_heads=2).replace(attn_backend="camformer", k_top=8,
                                        group_size=4, stage1_k=2)
    cache = {"k_packed": j_bacam.pack_bits(j_sign(k_raw)), "v": v,
             "k_scale": jnp.mean(jnp.abs(k_raw), axis=(2, 3))}
    return cfg, q, cache, k_new, v_new


def test_distributed_cam_search_matches_local(ranks):
    _, res, _ = ranks
    cfg, q, cache, _, _ = _cam_case()
    want = np.asarray(j_backend(cfg.backend)._cache_attend(
        q, cache, jnp.full((1,), 41, jnp.int32), jnp.full((1, 1), 40,
                                                          jnp.int32), cfg))
    for r in res:
        assert np.abs(r["cam"]["dist"] - want).max() < 1e-4
        assert np.abs(r["cam"]["dist"] - r["cam"]["local"]).max() < 1e-5


def test_distributed_cam_decode_matches_reference(ranks):
    """Through ``decode``: the new key and value land at position 40 of
    the whole cache (the third of four shards) with the reference's
    running k_scale, and the sharded search's output is the reference's
    decode within 1e-4 and the port's flag-off decode within 1e-5."""
    _, res, _ = ranks
    cfg, q, cache, k_new, v_new = _cam_case()
    want, want_cache = j_backend(cfg.backend).decode(
        q, cache, k_new, v_new, jnp.full((1,), 40, jnp.int32),
        jnp.full((1,), 41, jnp.int32), jnp.full((1, 1), 40, jnp.int32), cfg)
    for r in res:
        got = r["cam"]
        assert np.abs(got["dec"] - np.asarray(want)).max() < 1e-4
        assert np.abs(got["dec"] - got["dec_off"]).max() < 1e-5
        for k in want_cache:
            np.testing.assert_array_equal(got["cache"][k],
                                          got["cache_off"][k], err_msg=k)
        # the packed words: the port's int32, the reference's uint32
        np.testing.assert_array_equal(
            got["cache"]["k_packed"].view(np.uint32),
            np.asarray(want_cache["k_packed"]))
        for k in ("v", "k_scale"):
            np.testing.assert_allclose(got["cache"][k],
                                       np.asarray(want_cache[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_train_cli_on_four_processes(ranks):
    _, res, _ = ranks
    logs = [r["cli"]["log"] for r in res]
    assert [row["step"] for row in logs[0]] == [2]
    assert all(np.isfinite(row["loss"]) for row in logs[0])
    for log in logs[1:]:  # the global loss, the same on every process
        assert [row["loss"] for row in log] == [row["loss"]
                                                for row in logs[0]]
    # smoke batch max(8, data) = 8 rows, over data = 2
    assert [r["cli"]["rows"] for r in res] == [
        [0, 1, 2, 3], [0, 1, 2, 3], [4, 5, 6, 7], [4, 5, 6, 7]]
