"""The ``binary`` and ``hybrid`` paged backends, and the speculative
verify branch of the stateful backends, against the JAX reference.

One pool and page table go through ``paged_decode`` of both packages: a
prefill chunk (Sq = 12, right-padding rows, a prefix-sharing base, an
inert row), then a chunk of ``spec_k + 1`` = 4 columns — a speculative
verify chunk when ``spec_verify`` is set, with per-query scales and the
``k_means`` stash — then a decode step (Sq == 1, an inert row), under
both ``paged_impl`` realizations.  Outputs, ``k_scale``, ``k_means`` and
the float pools match to 1e-5 (f32); packed keys are bit-exact; page 0
(the trash page several padding rows write at once) is excluded.  The
page layouts of all four backends match the reference at spec_k 0 and 2,
and so do the verify forward's all-position logits (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.backend import get_backend as j_backend

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend as t_backend

SPEC_K = 3


def _cfg(mod, backend, impl, spec_k):
    # G = 2 query heads per kv head, 2 kv heads
    return mod("mistral-nemo-12b", attn_backend=backend, paged_impl=impl,
               n_heads=4, n_kv_heads=2, spec_k=spec_k)


def _pools(rng, backend, n_pages, hkv, page, d, b, spec_k):
    pools = {"v_pages": rng.standard_normal((n_pages, hkv, page, d)),
             "k_scale": rng.uniform(0.5, 1.5, (b, hkv))}
    if backend in ("binary", "hybrid"):
        pools["k_pages"] = rng.standard_normal((n_pages, hkv, page, d))
    if backend in ("camformer", "hybrid"):
        pools["kp_pages"] = rng.integers(-2**31, 2**31,
                                         (n_pages, hkv, page, d // 32))
    if spec_k:
        pools["k_means"] = np.zeros((b, hkv, spec_k + 1))
    return pools


def _to_jax(pools):
    return {name: jnp.asarray(x.astype(np.int32).view(np.uint32))
            if name == "kp_pages" else jnp.asarray(x.astype(np.float32))
            for name, x in pools.items()}


def _to_torch(pools):
    return {name: torch.from_numpy(
        x.astype(np.int32 if name == "kp_pages" else np.float32))
        for name, x in pools.items()}


def _compare(t_pools, j_pools, t_out, j_out, live):
    assert set(t_pools) == set(j_pools)
    for name, jx in j_pools.items():
        got, want = t_pools[name].numpy(), np.asarray(jx)
        if name == "kp_pages":
            np.testing.assert_array_equal(got[1:], want.view(np.int32)[1:])
        elif name in ("k_scale", "k_means"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    np.testing.assert_allclose(t_out.numpy()[live], np.asarray(j_out)[live],
                               rtol=1e-5, atol=1e-5)


def _step(jb, tb, jcfg, tcfg, j_pools, t_pools, rng, offsets, kv_len, base,
          table, s, h, hkv, d):
    b = len(offsets)
    pos = (offsets[:, None] + np.arange(s, dtype=np.int32)[None]).astype(
        np.int32)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    j_out, j_pools = jb.paged_decode(
        jnp.asarray(q), j_pools,
        *[jnp.asarray(x) for x in (k, v, pos, table, kv_len)], jcfg,
        base=jnp.asarray(base))
    t_out, t_pools = tb.paged_decode(
        torch.from_numpy(q), t_pools,
        *[torch.from_numpy(x) for x in (k, v, pos, table, kv_len)], tcfg,
        base=torch.from_numpy(base))
    live = np.zeros((b, h, s), bool)
    for i in range(b):
        live[i, :, : max(0, kv_len[i] - offsets[i])] = True
    _compare(t_pools, j_pools, t_out, j_out, live)
    return j_pools, t_pools, t_out


CASES = ([("binary", impl, verify) for impl in ("fused", "gather")
          for verify in (False, True)]
         + [("hybrid", impl, verify) for impl in ("fused", "gather")
            for verify in (False, True)]
         + [("camformer", impl, True) for impl in ("fused", "gather")])


@pytest.mark.parametrize("backend,impl,verify", CASES)
def test_paged_decode_matches_reference(backend, impl, verify):
    spec_k = SPEC_K if verify else 0
    jcfg, tcfg = (_cfg(j_smoke, backend, impl, spec_k),
                  _cfg(t_smoke, backend, impl, spec_k))
    b, hkv, h, d, page, np_ = 4, 2, 4, 32, 8, 5
    n_pages = 1 + b * np_
    rng = np.random.default_rng(CASES.index((backend, impl, verify)))
    pools = _pools(rng, backend, n_pages, hkv, page, d, b, spec_k)
    table = (1 + rng.permutation(n_pages - 1)[: b * np_]).reshape(b, np_)
    table = table.astype(np.int32)
    table[3, :] = 0  # an idle slot: every entry on the trash page
    j_pools, t_pools = _to_jax(pools), _to_torch(pools)
    jb, tb = j_backend(backend), t_backend(backend)
    dims = (h, hkv, d)

    # prefill chunk: slot 1 short (padding rows -> trash), slot 2 with a
    # shared prefix (base 8), slot 3 inert
    base = np.array([0, 0, 8, 0], np.int32)
    kv_len = np.array([12, 10, 20, 0], np.int32)
    j_pools, t_pools, _ = _step(
        jb, tb, jcfg, tcfg, j_pools, t_pools, rng,
        np.array([0, 4, 8, 0], np.int32), kv_len, base, table, 12, *dims)

    # a chunk of spec_k + 1 columns from each slot's end: under
    # spec_verify the verify branch (per-query scales, k_means); slot 1
    # takes two of its four positions, slot 3 stays inert
    vcfg = (jcfg.replace(spec_verify=verify),
            tcfg.replace(spec_verify=verify))
    n_tok = np.array([4, 2, 4, 0], np.int32)
    v_len = np.where(kv_len > 0, kv_len + n_tok, 0).astype(np.int32)
    j_pools, t_pools, _ = _step(
        jb, tb, *vcfg, j_pools, t_pools, rng, kv_len.copy(), v_len, base,
        table, SPEC_K + 1, *dims)
    if verify:
        assert np.abs(t_pools["k_means"].numpy()).sum() > 0

    # one decode step at each slot's next position; slot 3 inert
    d_len = np.where(v_len > 0, v_len + 1, 0).astype(np.int32)
    before = t_pools["k_scale"][3].clone()
    _, t_pools, t_out = _step(
        jb, tb, jcfg, tcfg, j_pools, t_pools, rng, v_len.copy(), d_len,
        base, table, 1, *dims)
    assert torch.equal(t_pools["k_scale"][3], before)  # inert: untouched
    if impl == "fused" and backend == "binary":
        assert torch.all(t_out[3] == 0)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_page_spec_matches_reference(spec_k):
    for backend in ("dense", "binary", "camformer", "hybrid"):
        jcfg, tcfg = (_cfg(j_smoke, backend, "fused", spec_k),
                      _cfg(t_smoke, backend, "fused", spec_k))
        want = j_backend(backend).page_spec(jcfg, 9, 8, 3, jnp.float32)
        got = t_backend(backend).page_spec(tcfg, 9, 8, 3, torch.float32)
        assert set(got) == set(want), backend
        for name, (shape, dt) in got.items():
            sds = want[name][0]
            assert isinstance(sds, jax.ShapeDtypeStruct)
            assert tuple(shape) == tuple(sds.shape), (backend, name)
            assert (dt == torch.int32) == (sds.dtype == jnp.uint32), name


@pytest.mark.parametrize("backend", ["binary", "hybrid"])
def test_verify_forward_matches_reference(backend):
    """``lm_verify_paged`` after a paged prefill: every position's logits
    (1e-4), and the stateful pools' k_scale / k_means (1e-5)."""
    from repro.models import get_model_def
    from repro.models.module import init_params as j_init

    from repro_torch.models import (from_jax_params, init_pools,
                                    lm_page_specs, lm_prefill_paged,
                                    lm_verify_paged)

    jcfg = j_smoke("camformer-bert", attn_backend=backend, spec_k=SPEC_K)
    tcfg = t_smoke("camformer-bert", attn_backend=backend, spec_k=SPEC_K)
    md = get_model_def(jcfg)
    params = j_init(md.specs(jcfg), jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
    b, page, np_ = 3, 8, 4
    rng = np.random.default_rng(7)
    table = (1 + np.arange(b * np_)).reshape(b, np_).astype(np.int32)
    lens = np.array([10, 5, 0], np.int32)
    tokens = rng.integers(0, jcfg.vocab, (b, 16)).astype(np.int32)
    drafts = rng.integers(0, jcfg.vocab, (b, SPEC_K + 1)).astype(np.int32)
    n_tok = np.array([4, 3, 0], np.int32)
    vbatch = {"tokens": drafts, "lens": np.where(lens > 0, lens + n_tok, 0),
              "offsets": lens, "scale_base": np.zeros(b, np.int32)}

    j_pools = jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype),
                           md.page_specs(jcfg, 1 + b * np_, page, b),
                           is_leaf=lambda x: isinstance(x, tuple)
                           and isinstance(x[0], jax.ShapeDtypeStruct))
    _, j_pools = md.prefill_paged(
        params, {"tokens": jnp.asarray(tokens), "lens": jnp.asarray(lens)},
        j_pools, jnp.asarray(table), jcfg)
    j_logits, j_pools = md.verify_paged(
        params, {k: jnp.asarray(np.asarray(x, np.int32))
                 for k, x in vbatch.items()}, j_pools, jnp.asarray(table),
        jcfg)

    t_pools = init_pools(lm_page_specs(tcfg, 1 + b * np_, page, b), "cpu")
    pt = torch.from_numpy(table)
    _, t_pools = lm_prefill_paged(
        tparams, {"tokens": torch.from_numpy(tokens),
                  "lens": torch.from_numpy(lens)}, t_pools, pt, tcfg)
    t_logits, t_pools = lm_verify_paged(
        tparams, {k: torch.from_numpy(np.asarray(x, np.int32))
                  for k, x in vbatch.items()}, t_pools, pt, tcfg)

    live = np.zeros((b, SPEC_K + 1), bool)
    for i in range(b):
        live[i, :n_tok[i]] = True
    np.testing.assert_allclose(t_logits.numpy()[live],
                               np.asarray(j_logits)[live], rtol=1e-4,
                               atol=1e-4)
    for i, layer in enumerate(t_pools):
        jl = jax.tree.map(lambda x: np.asarray(x)[i], j_pools)
        for name in ("k_scale", "k_means"):
            np.testing.assert_allclose(layer[name].numpy(), jl[name],
                                       rtol=1e-5, atol=1e-6, err_msg=name)
