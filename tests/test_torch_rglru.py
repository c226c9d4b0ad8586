"""The port's Griffin hybrid family (``recurrentgemma-2b``, family
``hybrid``) against the JAX reference at f32 smoke width, the same numpy
inputs through both and the reference's weights carried over by
``models.from_jax_params``: the causal conv and the RG-LRU block (1e-5);
each backend's decode against a ring cache whose slots hold rotated
positions (1e-5, caches too); the whole model at 8 layers (two periods
and both trailing rec layers) with the window cut to 16, prompts longer
and shorter than the window and decode past the ring's wrap (logits
1e-4, greedy streams equal, both sides fed the reference's picks); the
loss (1e-5) and every gradient leaf (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.backend import get_backend as j_backend
from repro.launch.steps import cast_params as j_cast
from repro.models import get_model_def as j_model_def
from repro.models import rglru as j_rglru
from repro.models.module import init_params as j_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend as t_backend
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_value_and_grad)
from repro_torch.models import from_jax_params, get_model_def, init_pools
from repro_torch.models import rglru as t_rglru
from repro_torch.models.convert import stack_blocks

ARCH = "recurrentgemma-2b"
TOL = 1e-5


def _setup(**kw):
    kw.setdefault("n_layers", 8)  # 2 periods of (rec, rec, attn) + 2 tail
    jc, tc = j_smoke(ARCH, **kw), t_smoke(ARCH, **kw)
    md = j_model_def(jc)
    jp = j_init(md.specs(jc), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, md, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _rec_state(cfg, b, rng):
    r, w = cfg.rnn_width, cfg.conv_width
    return {"conv": rng.standard_normal((b, w - 1, r)).astype(np.float32),
            "h": rng.standard_normal((b, r)).astype(np.float32)}


def test_layout_and_parameters():
    _, tc, _, jp, tp = _setup()
    assert t_rglru._layout(tc) == (3, 2, 2)
    assert len(tp["rec1"]) == len(tp["rec2"]) == len(tp["attn"]) == 2
    assert {"tail_rec1", "tail_rec2"} <= set(tp)
    assert not any(k.startswith("tail") for k in _setup(n_layers=6)[4])


@pytest.mark.parametrize("s", [1, 7])
def test_causal_conv_matches_reference(s):
    _, tc, _, jp, tp = _setup()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s, tc.rnn_width)).astype(np.float32)
    state = _rec_state(tc, 2, rng)["conv"]
    p_j = jax.tree.map(lambda a: a[0], jp["rec1"])
    got = t_rglru._causal_conv(torch.from_numpy(x), torch.from_numpy(state),
                               tp["rec1"][0]["conv_w"],
                               tp["rec1"][0]["conv_b"])
    want = j_rglru._causal_conv(jnp.asarray(x), jnp.asarray(state),
                                p_j["conv_w"], p_j["conv_b"])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s", [1, 9])
def test_rg_lru_block_matches_reference(s):
    """One recurrent block (+ MLP) from a nonzero conv window and state:
    the output and both new states."""
    jc, tc, _, jp, tp = _setup()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, tc.d_model)).astype(np.float32)
    state = _rec_state(tc, 2, rng)
    p_j = jax.tree.map(lambda a: a[1], jp["rec2"])
    want_x, want_c = j_rglru._apply_rec(
        p_j, jnp.asarray(x), jc, jax.tree.map(jnp.asarray, state))
    got = t_rglru._apply_rec(tp["rec2"][1], torch.from_numpy(x), tc,
                             {k: torch.from_numpy(v) for k, v in
                              state.items()})
    _close(got[0], want_x)
    _close(got[1], want_c["conv"])
    _close(got[2], want_c["h"])


@pytest.mark.parametrize("backend,use_kernel", [
    ("dense", False), ("binary", False), ("camformer", False),
    ("camformer", True)])
def test_ring_decode_matches_reference(backend, use_kernel):
    """One decode row a batch row against a 16-slot ring that has
    wrapped: slot i holds position base + ((i - base) mod 16), a
    different rotation per row, the new token written at its slot
    pos mod 16; window 16, GQA (4 heads on 1 kv head)."""
    kw = dict(attn_backend=backend, use_kernel=use_kernel, window=16)
    jc, tc = j_smoke(ARCH, **kw), t_smoke(ARCH, **kw)
    jb, tb = j_backend(backend), t_backend(backend)
    b, wlen, hkv, h, d = 3, 16, tc.n_kv_heads, tc.n_heads, tc.head_dim
    rng = np.random.default_rng(3)
    pos = np.array([16, 29, 40], np.int32)  # the new token's position
    slots = pos % wlen
    # the ring before the write: the wlen positions below pos
    kv_pos = np.stack([np.array([p - wlen + ((i - p) % wlen)
                                 for i in range(wlen)])
                       for p in pos]).astype(np.int32)
    kv_pos[np.arange(b), slots] = pos  # decode updates attn_pos first
    spec = {n: (shape, dt) for n, (shape, dt) in
            tb.cache_spec(tc, b, wlen, torch.float32).items()}
    cache = {}
    for n, (shape, dt) in spec.items():
        if dt == torch.int32:
            cache[n] = rng.integers(-2**31, 2**31 - 1, shape,
                                    dtype=np.int64).astype(np.int32)
        else:
            cache[n] = np.abs(rng.standard_normal(shape)).astype(np.float32)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
            for _ in range(2))
    args = (q, k, v, slots, pos + 1, pos[:, None], kv_pos)
    j_in = [jnp.asarray(a) for a in args]
    jcache = {n: jnp.asarray(a.view(np.uint32) if a.dtype == np.int32
                             else a) for n, a in cache.items()}
    want, jcache = jb.decode(j_in[0], jcache, *j_in[1:6], jc,
                             kv_positions=j_in[6], window=jc.window)
    t_in = [torch.from_numpy(a) for a in args]
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got, tcache = tb.decode(t_in[0], tcache, *t_in[1:6], tc,
                            kv_positions=t_in[6], window=tc.window)
    _close(got, want)
    for n, t in tcache.items():
        j = np.asarray(jcache[n])
        if j.dtype == np.uint32:
            np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
        else:
            _close(t, j)


def _zeros(specs):
    return jax.tree.map(
        lambda t: jnp.zeros(t[0].shape, t[0].dtype), specs,
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], jax.ShapeDtypeStruct))


@pytest.mark.parametrize("backend,use_kernel,prompt", [
    ("dense", False, 24), ("dense", False, 10), ("binary", False, 24),
    ("camformer", False, 24), ("camformer", True, 24),
    ("camformer", True, 10)])
def test_prefill_decode_past_the_wrap(backend, use_kernel, prompt):
    """Window 16 and a 40-token cache (a 16-slot ring): a prompt longer
    than the window (the ring holds its trailing 16 positions) or
    shorter (slots past it unwritten), then 12 decode steps that wrap
    the ring; logits 1e-4 at every step, greedy picks equal, the ring's
    ``attn_pos`` equal and the final caches 1e-4."""
    jc, tc, md, jp, tp = _setup(attn_backend=backend, use_kernel=use_kernel,
                                window=16)
    b, steps, cache_len = 2, 12, 40
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jc.vocab, (b, prompt)).astype(np.int32)
    jcaches = _zeros(md.cache_specs(jc, b, cache_len))
    tmd = get_model_def(tc)
    tcaches = init_pools(tmd.cache_specs(tc, b, cache_len), "cpu")
    assert tcaches["attn_pos"].shape == (b, 16)
    jl, jcaches = jax.jit(md.prefill, static_argnums=3)(
        jp, {"tokens": jnp.asarray(tokens)}, jcaches, jc)
    tl, tcaches = make_prefill_step(tmd, tc)(
        tp, {"tokens": torch.from_numpy(tokens)}, tcaches)
    j_decode = jax.jit(md.decode, static_argnums=5)
    t_serve = make_serve_step(tmd, tc)
    pos = np.full((b,), prompt, np.int32)
    for step in range(steps + 1):
        _close(tl, jl, 1e-4)
        np.testing.assert_array_equal(tcaches["attn_pos"].numpy(),
                                      np.asarray(jcaches["attn_pos"]))
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
    assert (pos > 16).all()  # the ring wrapped
    for key in ("rec1", "rec2", "attn"):
        for i, tc_i in enumerate(tcaches[key]):
            for n, t in tc_i.items():
                j = np.asarray(jcaches[key][n][i])
                if j.dtype == np.uint32:
                    np.testing.assert_array_equal(t.numpy(),
                                                  j.view(np.int32))
                else:
                    _close(t, j, 1e-4)
    for n, t in tcaches["tail_rec2"].items():
        _close(t, jcaches["tail_rec2"][n], 1e-4)


@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_loss_and_every_gradient_leaf(backend):
    jc, tc, md, jp, tp = _setup(attn_backend=backend, window=16)
    rng = np.random.default_rng(6)
    b, s = 2, 24
    batch = {"tokens": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: md.loss(j_cast(p, jnp.float32), bt, jc),
        has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    tl, taux, tg = make_value_and_grad(get_model_def(tc), tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5, atol=1e-5)
    ported = stack_blocks(tg)
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(jax.tree.leaves(ported))
    for path, want in leaves:
        got = ported
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
