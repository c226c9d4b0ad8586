"""The port's encoder-decoder family (``whisper-medium``, family
``audio``) against the JAX reference at f32 smoke width, the same numpy
inputs through both and the reference's weights carried over by
``models.from_jax_params``: sinusoidal positions and both GELU MLPs
(1e-5); the attention block's cross-attention and non-causal modes on
``dense``, ``binary`` and ``camformer`` (1e-5); the encoder and
``prefill`` + ``decode`` through ``launch/steps`` (1e-4, greedy streams
equal, both sides fed the reference's picks); the loss (1e-5) and every
gradient leaf (1e-4); and ``stack_blocks`` back to the reference's
layout, through a checkpoint of each package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.steps import cast_params as j_cast
from repro.models import encdec as j_encdec
from repro.models import get_model_def as j_model_def
from repro.models import layers as j_layers
from repro.models.attention import attention_block as j_attention_block
from repro.models.module import init_params as j_init
from repro.train import checkpoint as j_ckpt

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_value_and_grad)
from repro_torch.models import (from_jax_params, get_model_def, init_params,
                                init_pools)
from repro_torch.models import encdec as t_encdec
from repro_torch.models import layers as t_layers
from repro_torch.models.attention import attention_block as t_attention_block
from repro_torch.models.convert import stack_blocks
from repro_torch.train import checkpoint as t_ckpt

ARCH = "whisper-medium"
TOL = 1e-5


def _setup(**kw):
    jc, tc = j_smoke(ARCH, **kw), t_smoke(ARCH, **kw)
    md = j_model_def(jc)
    jp = j_init(md.specs(jc), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, md, jp, tp


def _features(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


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


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoidal_positions_match_reference(d):
    """1e-5 at the smoke model's positions (below 64).  Over whisper's
    1500 encoder frames the two packages' float32 ``exp`` may round a
    frequency (at most 1) one ulp (2**-24) apart; the angle at position
    p < 2048 then differs by up to p * 2**-24 before rounding, and the
    two roundings of it to float32 add one ulp of the angle (2**-13), so
    there the bound is 1e-5 + 1500 * 2**-24 + 2**-13."""
    rng = np.random.default_rng(0)
    for hi, tol in ((64, TOL), (1500, TOL + 1500 * 2**-24 + 2**-13)):
        pos = rng.integers(0, hi, (3, 7)).astype(np.int32)
        _close(t_layers.sinusoidal_positions(torch.from_numpy(pos), d),
               j_layers.sinusoidal_positions(jnp.asarray(pos), d), tol)


@pytest.mark.parametrize("arch", ["whisper-medium", "recurrentgemma-2b"])
def test_gelu_mlps_match_reference(arch):
    """The plain biased 2-layer GELU MLP (whisper) and the gated GeGLU
    (recurrentgemma), both with the tanh GELU of ``jax.nn.gelu``."""
    jc, tc = j_smoke(arch), t_smoke(arch)
    rng = np.random.default_rng(1)
    p = {name: (rng.standard_normal(shape) * 0.3).astype(np.float32)
         for name, (shape, *_) in t_layers.mlp_shapes(tc).items()}
    assert ("w_gate" in p) == (arch == "recurrentgemma-2b")
    x = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
    _close(t_layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), tc),
           j_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jc))


@pytest.mark.parametrize("mode", ["cross", "non-causal"])
@pytest.mark.parametrize("backend", ["dense", "binary", "camformer"])
def test_attention_block_cross_and_non_causal(backend, mode):
    """Cross-attention of 6 decoder rows over 16 encoder keys (K/V given,
    no RoPE, no cache), and the encoder's non-causal self-attention."""
    jc, tc, _, jp, tp = _setup(attn_backend=backend)
    p_j = jax.tree.map(lambda a: a[0], jp["dec_blocks"]["cross_attn"])
    p_t = tp["dec_blocks"][0]["cross_attn"]
    rng = np.random.default_rng(2)
    b, s = 2, 6 if mode == "cross" else 16
    x = rng.standard_normal((b, s, tc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kw_j, kw_t = {}, {}
    if mode == "cross":
        kv = [rng.standard_normal((b, tc.n_kv_heads, 16, tc.head_dim))
              .astype(np.float32) for _ in range(2)]
        kw_j["cross_kv"] = tuple(jnp.asarray(a) for a in kv)
        kw_t["cross_kv"] = tuple(torch.from_numpy(a) for a in kv)
    else:
        kw_j["causal"] = kw_t["causal"] = False
    want, _ = j_attention_block(p_j, jnp.asarray(x), jc,
                                positions=jnp.asarray(pos), **kw_j)
    got, cache = t_attention_block(p_t, torch.from_numpy(x), tc,
                                   positions=torch.from_numpy(pos), **kw_t)
    assert cache is None
    _close(got, want)


def test_encoder_matches_reference():
    jc, tc, _, jp, tp = _setup(attn_backend="camformer")
    feats = _features(tc, 2, 3)
    _close(t_encdec.encode(tp, torch.from_numpy(feats), tc),
           j_encdec.encode(jp, jnp.asarray(feats), jc), 1e-4)


@pytest.mark.parametrize("backend,use_kernel", [
    ("dense", False), ("binary", False), ("camformer", False),
    ("camformer", True)])
def test_prefill_decode_match_reference(backend, use_kernel):
    """prefill of 6-token prompts over 16 encoder frames, then 8 decode
    steps in a 16-slot cache: logits 1e-4 at every step, the port's
    greedy picks equal the reference's, the caches' memory 1e-4."""
    jc, tc, md, jp, tp = _setup(attn_backend=backend, use_kernel=use_kernel)
    b, s, steps, cache_len = 2, 6, 8, 16
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "audio_features": _features(tc, b, 5)}
    jcaches = jax.tree.map(
        lambda t: jnp.zeros(t[0].shape, t[0].dtype),
        md.cache_specs(jc, b, cache_len),
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], jax.ShapeDtypeStruct))
    tmd = get_model_def(tc)
    tcaches = init_pools(tmd.cache_specs(tc, b, cache_len), "cpu")
    jl, jcaches = jax.jit(md.prefill, static_argnums=3)(
        jp, jax.tree.map(jnp.asarray, batch), jcaches, jc)
    tl, tcaches = make_prefill_step(tmd, tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcaches)
    _close(tcaches["memory"], jcaches["memory"], 1e-4)
    j_decode = jax.jit(md.decode, static_argnums=5)
    t_serve = make_serve_step(tmd, tc)
    pos = np.full((b,), s, np.int32)
    for step in range(steps + 1):
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step == steps:
            break
        jl, jcaches = j_decode(jp, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(pos + 1), jcaches, jc)
        tl, tcaches = t_serve(tp, torch.from_numpy(tok),
                              torch.from_numpy(pos),
                              torch.from_numpy(pos + 1), tcaches)
        pos = pos + 1


@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_loss_and_every_gradient_leaf(backend):
    jc, tc, md, jp, tp = _setup(attn_backend=backend)
    rng = np.random.default_rng(6)
    b, s = 2, 12
    batch = {"tokens": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32),
             "audio_features": _features(tc, b, 7)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: md.loss(j_cast(p, jnp.float32), bt, jc),
        has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    tl, taux, tg = make_value_and_grad(get_model_def(tc), tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5, atol=1e-5)
    _assert_tree_close(tg, jg, 1e-4)


def test_stack_blocks_round_trip_and_checkpoints(tmp_path):
    """The port's encoder and decoder lists stack back to the
    reference's arrays bit for bit, and a checkpoint written by either
    package restores in the other."""
    jc, tc, _, jp, tp = _setup()
    stacked = stack_blocks(tp)
    leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(leaves) == len(jax.tree.leaves(stacked))
    for path, want in leaves:
        got = stacked
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(want))
    # port -> reference
    t_ckpt.save_checkpoint(str(tmp_path / "t"), {"params": tp}, 3)
    restored, step = j_ckpt.restore_checkpoint(
        str(tmp_path / "t"), {"params": jax.tree.map(jnp.zeros_like, jp)})
    assert step == 3
    for a, b in zip(jax.tree.leaves(restored["params"]),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # reference -> port
    j_ckpt.save_checkpoint(str(tmp_path / "j"), {"params": jp}, 5)
    into = {"params": init_params(tc, device="cpu", seed=1)}
    t_ckpt.restore_checkpoint(str(tmp_path / "j"), into)
    for a, b in zip(jax.tree.leaves(stack_blocks(into)["params"]),
                    jax.tree.leaves(stack_blocks({"params": tp})["params"])):
        np.testing.assert_array_equal(a, b)
