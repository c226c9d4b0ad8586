"""The port's contiguous-cache path against the JAX reference: the cache
writes of both backends, and ``lm_prefill`` followed by 6 ``lm_decode``
steps through ``launch/steps`` for ``camformer-bert`` (G = 1) and
``mistral-nemo-12b`` (G = 4) smoke configs, on ``camformer`` with and
without ``use_kernel``, ``dense`` and the mixed ``dense,camformer``
stack, with and without ``prefill_chunk``; the MoE family at
``granite-moe-3b-a800m``'s G = 3 (6 heads on 2 kv heads) and
``moonshot-v1-16b-a3b`` smoke, and ``llava-next-mistral-7b`` smoke with
its 8 patch embeddings prepended (``image_embeds``; decode starts after
the patches).

Weights are the reference's, passed through ``models.from_jax_params``.
Both sides are fed the reference's greedy picks, so one argmax near-tie
cannot fork the streams; the port's own picks must equal them.  Logits
to 1e-4, packed keys bit-identical, float cache leaves to 1e-5.

The reference cannot run one of these settings: with ``use_kernel`` and
G > 1 a prefill chunk (Sq > 1) fails in ``_cache_attend``, whose row
positions broadcast (B, 1, Sq) to (B, H_kv, G * Sq).  The port folds the
rows as r = g * Sq + s, as the reference's plain branch does, so there
it is held against the reference with ``use_kernel`` off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.backend import get_backend as j_backend
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend as t_backend
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (from_jax_params, get_model_def, init_pools,
                                lm_cache_specs)

_IS_SPEC = (lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], jax.ShapeDtypeStruct))


def _zeros(specs):
    return jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype), specs,
                        is_leaf=_IS_SPEC)


def _assert_cache_equal(tcache, jcache):
    """One layer's contiguous cache: packed keys bit-identical, float
    leaves to 1e-5."""
    assert set(tcache) == set(jcache)
    for name, t in tcache.items():
        j = np.asarray(jcache[name])
        if j.dtype == np.uint32:
            np.testing.assert_array_equal(t.numpy(), j.view(np.int32))
        else:
            np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_cache_writes_match_reference(backend):
    """write_cache at 0, a per-row write whose start runs past the end
    (clamped to L - S as dynamic_update_slice does), a scalar write at
    an offset, and an update longer than the cache (trailing slice)."""
    jcfg = j_smoke("camformer-bert", attn_backend=backend)
    tcfg = t_smoke("camformer-bert", attn_backend=backend)
    jb, tb = j_backend(backend), t_backend(backend)
    b, length = 3, 12
    jc = _zeros(jb.cache_spec(jcfg, b, length, jnp.float32))
    tc = init_pools([tb.cache_spec(tcfg, b, length, torch.float32)],
                    "cpu")[0]
    rng = np.random.default_rng(1)
    hkv, d = tcfg.n_kv_heads, tcfg.head_dim
    writes = [(5, 0), (2, np.array([5, 11, 20], np.int32)), (3, 4),
              (15, 0)]
    for s, index in writes:
        k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
        jc = jb.write_cache(jc, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(index, jnp.int32), jcfg)
        tc = tb.write_cache(tc, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(np.asarray(index)), tcfg)
        _assert_cache_equal(tc, jc)


# granite's GQA group at smoke width: G = 24 / 8 = 3
OVERRIDES = {"granite-moe-3b-a800m": dict(n_heads=6, n_kv_heads=2)}


def _configs(arch, backend, use_kernel, chunk):
    kw = ({"layer_backends": tuple(backend.split(","))} if "," in backend
          else {"attn_backend": backend})
    kw.update(use_kernel=use_kernel, prefill_chunk=chunk)
    kw.update(OVERRIDES.get(arch, {}))
    tcfg = t_smoke(arch, **kw)
    if use_kernel and chunk and tcfg.n_heads > tcfg.n_kv_heads:
        kw["use_kernel"] = False  # the reference's kernel branch fails here
    return j_smoke(arch, **kw), tcfg


CASES = [(arch, backend, use_kernel, chunk)
         for arch in ("camformer-bert", "mistral-nemo-12b")
         for backend, use_kernel in (("camformer", True),
                                     ("camformer", False), ("dense", False),
                                     ("dense,camformer", True))
         for chunk in (0, 4)]
# the MoE family (the chunked leg reaches 3b) and the VLM with patches
CASES += [("granite-moe-3b-a800m", "camformer", True, 0),
          ("granite-moe-3b-a800m", "camformer", True, 4),
          ("granite-moe-3b-a800m", "dense", False, 0),
          ("moonshot-v1-16b-a3b", "camformer", True, 4),
          ("llava-next-mistral-7b", "camformer", False, 0),
          ("llava-next-mistral-7b", "dense", False, 4)]


@pytest.mark.parametrize("arch,backend,use_kernel,chunk", CASES)
def test_contiguous_prefill_decode_match_reference(arch, backend, use_kernel,
                                                   chunk):
    jcfg, tcfg = _configs(arch, backend, use_kernel, chunk)
    md = j_model_def(jcfg)
    jparams = j_init(md.specs(jcfg), jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    b, s, steps = 2, 8, 6
    n_img = jcfg.n_patches  # VLM: patch embeddings ahead of the text
    cache_len = 16 + n_img
    jcaches = _zeros(md.cache_specs(jcfg, b, cache_len))
    tcaches = init_pools(lm_cache_specs(tcfg, b, cache_len), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)}
    if n_img:
        batch["image_embeds"] = rng.standard_normal(
            (b, n_img, jcfg.d_model)).astype(np.float32)

    tmd = get_model_def(tcfg)
    t_prefill = make_prefill_step(tmd, tcfg)
    t_serve = make_serve_step(tmd, tcfg)
    jl, jcaches = jax.jit(md.prefill, static_argnums=3)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcaches,
        jcfg)
    tl, tcaches = t_prefill(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()}, tcaches)
    j_decode = jax.jit(md.decode, static_argnums=5)
    pos = np.full((b,), n_img + s, np.int32)
    for step in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step == steps:
            break
        jl, jcaches = j_decode(jparams, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(pos + 1), jcaches, jcfg)
        tl, tcaches = t_serve(tparams, torch.from_numpy(tok),
                              torch.from_numpy(pos),
                              torch.from_numpy(pos + 1), tcaches)
        pos = pos + 1
    # the final caches, layer by layer (a uniform reference stack is
    # layer-stacked, a mixed one a tuple)
    for i, tc in enumerate(tcaches):
        jc = (jcaches[i] if isinstance(jcaches, tuple)
              else {k: v[i] for k, v in jcaches.items()})
        _assert_cache_equal(tc, jc)
