"""The port's train step against the JAX reference, both started from the
reference's parameters (``from_jax_params`` / ``from_jax_state``) on the
same numpy batch, at f32 smoke width: the loss (1e-5) and every gradient
leaf (1e-4) of ``make_value_and_grad`` against
``jax.value_and_grad(md.loss)`` on ``dense``, ``binary``, ``camformer``
with ``use_kernel`` on and off, the mixed ``dense,camformer`` stack,
``granite-moe-3b-a800m`` at G = 3 (the MoE aux loss) and
``llava-next-mistral-7b`` (the VLM loss over patch embeddings); three
successive ``make_train_step`` steps against the reference's (losses and
metrics 1e-5); ``accum=2``; and remat on and off equal in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.steps import cast_params as j_cast
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init
from repro.models.transformer import dtype_of as j_dtype

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch.steps import (METRIC_KEYS, make_train_step,
                                      make_value_and_grad)
from repro_torch.models import (from_jax_params, from_jax_state,
                                get_model_def)
from repro_torch.models.convert import stack_blocks

CONFIGS = {
    "dense": ("camformer-bert", dict(attn_backend="dense")),
    "binary": ("camformer-bert", dict(attn_backend="binary")),
    "camformer": ("camformer-bert", dict(attn_backend="camformer")),
    "camformer-kernel": ("camformer-bert", dict(attn_backend="camformer",
                                                use_kernel=True)),
    "dense,camformer": ("camformer-bert",
                        dict(layer_backends=("dense", "camformer"))),
    # granite's GQA group at smoke width: G = 24 / 8 = 3
    "granite-moe": ("granite-moe-3b-a800m", dict(n_heads=6, n_kv_heads=2)),
    "llava-vlm": ("llava-next-mistral-7b", dict(attn_backend="camformer",
                                                use_kernel=True)),
}


def _setup(name, **extra):
    arch, kw = CONFIGS[name]
    kw = dict(kw, **extra)
    jc, tc = j_smoke(arch, **kw), t_smoke(arch, **kw)
    md = j_model_def(jc)
    params = j_init(md.specs(jc), jax.random.PRNGKey(0))
    return jc, tc, md, params


def _batch(cfg, seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(port_tree, jax_tree, tol):
    ported = stack_blocks(port_tree)
    leaves = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(leaves) == len(jax.tree.leaves(ported))
    for path, want in leaves:
        got = ported
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_every_gradient_leaf(name):
    jc, tc, md, params = _setup(name)
    batch = _batch(jc, 0)
    dt = j_dtype(jc)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: md.loss(j_cast(p, dt), bt, jc), has_aux=True))(
            params, jax.tree.map(jnp.asarray, batch))
    tp = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    tl, taux, tg = make_value_and_grad(get_model_def(tc), tc)(
        tp, _torch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    for key, want in jaux.items():
        np.testing.assert_allclose(float(taux[key]), float(want), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    if tc.n_experts:
        assert float(taux["moe_aux_loss"]) > 0
    _assert_tree_close(tg, jg, 1e-4)


def _reference_steps(jc, md, params, batches, **kw):
    step_fn, opt = j_make_train_step(md, jc, peak_lr=1e-3, warmup=2,
                                     total_steps=10, **kw)
    state = {"params": params, "opt": opt.init(params)}
    state0 = jax.tree.map(np.asarray, state)
    step_fn = jax.jit(step_fn)
    out = []
    for bt in batches:
        state, metrics = step_fn(state, jax.tree.map(jnp.asarray, bt))
        out.append({k: float(v) for k, v in metrics.items()})
    return state0, out, state


def _port_steps(md, tc, state, batches, **kw):
    step_fn, _ = make_train_step(md, tc, peak_lr=1e-3, warmup=2,
                                 total_steps=10, **kw)
    out = []
    for bt in batches:
        state, metrics = step_fn(state, _torch(bt))
        assert set(metrics) == set(METRIC_KEYS)
        out.append({k: float(v) for k, v in metrics.items()})
    return out, state


@pytest.mark.parametrize("name,accum", [("camformer-kernel", 1),
                                        ("dense", 2)])
def test_three_train_steps_match_the_reference(name, accum):
    """Three steps of ``make_train_step`` (cosine warmup 2, AdamW, clip):
    every metric of every step within 1e-5, the parameters after the last
    within 1e-4; with ``accum=2`` the batch runs as two microbatches."""
    jc, tc, md, params = _setup(name)
    batches = [_batch(jc, 10 + i, b=4) for i in range(3)]
    state0, j_metrics, j_state = _reference_steps(jc, md, params, batches,
                                                  accum=accum)
    state = from_jax_state(state0, tc, "cpu")
    t_metrics, t_state = _port_steps(get_model_def(tc), tc, state, batches,
                                     accum=accum)
    for got, want in zip(t_metrics, j_metrics):
        for key in METRIC_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
    assert t_metrics[0]["loss"] != t_metrics[2]["loss"]
    assert int(t_state["opt"]["step"]) == 3
    _assert_tree_close(t_state["params"], j_state["params"], 1e-4)


@pytest.mark.parametrize("name", ["camformer-kernel", "granite-moe"])
def test_remat_on_and_off_agree(name, monkeypatch):
    """Recomputing each block in the backward pass (``remat="full"``)
    gives the same loss and gradients as keeping the activations; the
    BA-CAM score function then runs twice a layer (forward and
    recompute), once without."""
    from repro_torch.kernels import bacam_mvm

    calls = []
    plain = bacam_mvm.bacam_scores_ref
    monkeypatch.setattr(bacam_mvm, "bacam_scores_ref",
                        lambda *a: calls.append(1) or plain(*a))
    _, tc, _, params = _setup(name)
    tp = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    batch = _torch(_batch(tc, 1))
    runs = []
    for remat in ("full", "none"):
        cfg = tc.replace(remat=remat)
        calls.clear()
        runs.append(make_value_and_grad(get_model_def(cfg), cfg)(tp, batch))
        if tc.use_kernel:
            assert len(calls) == tc.n_layers * (2 if remat == "full" else 1)
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    for a, b in zip(jax.tree.leaves(stack_blocks(g1)),
                    jax.tree.leaves(stack_blocks(g2))):
        np.testing.assert_array_equal(a, b)
