"""Paged attention backends of the port against the JAX reference:
``paged_decode`` of ``dense`` and ``camformer`` on one pool and page
table, for a prefill chunk (Sq > 1, right-padding rows, a nonzero
prefix-sharing base, an inert row) followed by a decode step (Sq == 1,
an inert row), under both ``paged_impl`` realizations.

Packed keys and the page table must be bit-exact with page 0 excluded
(several padding rows write the trash page 0 at once, so its contents
are arbitrary in both frameworks); values, ``k_scale`` and outputs match
to 1e-5 (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.backend import get_backend as j_backend

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend as t_backend


def _cfg(mod, backend, impl):
    # G = 2 query heads per kv head, 2 kv heads
    return mod("mistral-nemo-12b", attn_backend=backend, paged_impl=impl,
               n_heads=4, n_kv_heads=2)


def _pools(rng, backend, n_pages, hkv, page, d, b):
    if backend == "dense":
        return {"k_pages": rng.standard_normal((n_pages, hkv, page, d)),
                "v_pages": rng.standard_normal((n_pages, hkv, page, d))}
    return {"kp_pages": rng.integers(-2**31, 2**31,
                                     (n_pages, hkv, page, d // 32)),
            "v_pages": rng.standard_normal((n_pages, hkv, page, d)),
            "k_scale": rng.uniform(0.5, 1.5, (b, hkv))}


def _to_jax(pools):
    out = {}
    for name, x in pools.items():
        if name == "kp_pages":
            out[name] = jnp.asarray(x.astype(np.int32).view(np.uint32))
        else:
            out[name] = jnp.asarray(x.astype(np.float32))
    return out


def _to_torch(pools):
    out = {}
    for name, x in pools.items():
        dt = np.int32 if name == "kp_pages" else np.float32
        out[name] = torch.from_numpy(x.astype(dt))
    return out


def _compare(t_pools, j_pools, t_out, j_out, live):
    for name, jx in j_pools.items():
        got = t_pools[name].numpy()
        want = np.asarray(jx)
        if name == "kp_pages":
            np.testing.assert_array_equal(got[1:], want.view(np.int32)[1:])
        elif name == "k_scale":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(t_out.numpy()[live], np.asarray(j_out)[live],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["fused", "gather"])
@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_paged_decode_matches_reference(backend, impl):
    jcfg, tcfg = _cfg(j_smoke, backend, impl), _cfg(t_smoke, backend, impl)
    b, hkv, h, d, page, np_ = 4, 2, 4, 32, 8, 5
    n_pages = 1 + b * np_
    rng = np.random.default_rng(
        ["dense", "camformer"].index(backend) * 2 + (impl == "gather"))
    pools = _pools(rng, backend, n_pages, hkv, page, d, b)
    table = (1 + rng.permutation(n_pages - 1)[: b * np_]).reshape(b, np_)
    table = table.astype(np.int32)
    table[3, :] = 0  # an idle slot: every entry on the trash page
    j_pools, t_pools = _to_jax(pools), _to_torch(pools)
    jb, tb = j_backend(backend), t_backend(backend)

    # --- prefill chunk: S = 12 rows from per-slot offsets; slot 1 is
    # short (rows past kv_len are padding -> trash), slot 2 shares a
    # prefix (base 8), slot 3 is inert
    s = 12
    offsets = np.array([0, 4, 8, 0], np.int32)
    kv_len = np.array([12, 10, 20, 0], np.int32)
    base = np.array([0, 0, 8, 0], np.int32)
    pos = (offsets[:, None] + np.arange(s, dtype=np.int32)[None]).astype(
        np.int32)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    k[0, 0, 3, 5] = 0.0  # an exact zero key element: packs as bit 0
    j_out, j_pools = jb.paged_decode(
        *[jnp.asarray(x) for x in (q,)], j_pools,
        *[jnp.asarray(x) for x in (k, v, pos, table, kv_len)], jcfg,
        base=jnp.asarray(base))
    t_out, t_pools = tb.paged_decode(
        torch.from_numpy(q), t_pools,
        *[torch.from_numpy(x) for x in (k, v, pos, table, kv_len)], tcfg,
        base=torch.from_numpy(base))
    # rows past kv_len attend to nothing valid beyond the slot: compare
    # the rows whose query position is valid
    live = np.zeros((b, h, s), bool)
    for i in range(b):
        live[i, :, : max(0, kv_len[i] - offsets[i])] = True
    _compare(t_pools, j_pools, t_out, j_out, live)

    # --- one decode step at each slot's next position; slot 3 inert
    dpos = kv_len[:, None].copy()
    dkv = np.where(kv_len > 0, kv_len + 1, 0).astype(np.int32)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    j_out, j_pools = jb.paged_decode(
        jnp.asarray(q), j_pools,
        *[jnp.asarray(x) for x in (k, v, dpos, table, dkv)], jcfg,
        base=jnp.asarray(base))
    t_out, t_pools = tb.paged_decode(
        torch.from_numpy(q), t_pools,
        *[torch.from_numpy(x) for x in (k, v, dpos, table, dkv)], tcfg,
        base=torch.from_numpy(base))
    live = np.broadcast_to((dkv > 0)[:, None, None], (b, h, 1))
    _compare(t_pools, j_pools, t_out, j_out, live)
    # inert rows: a kernel-path output of zeros, and k_scale untouched
    if backend == "camformer":
        np.testing.assert_array_equal(t_pools["k_scale"][3].numpy(),
                                      pools["k_scale"][3].astype(np.float32))
    if impl == "fused":
        assert torch.all(t_out[3] == 0)


def test_page_spec_matches_reference():
    import jax

    for backend in ("dense", "camformer"):
        jcfg, tcfg = (_cfg(j_smoke, backend, "fused"),
                      _cfg(t_smoke, backend, "fused"))
        want = j_backend(backend).page_spec(jcfg, 9, 8, 3, jnp.float32)
        got = t_backend(backend).page_spec(tcfg, 9, 8, 3, torch.float32)
        assert set(got) == set(want)
        for name, (shape, _) in got.items():
            sds = want[name][0]
            assert isinstance(sds, jax.ShapeDtypeStruct)
            assert tuple(shape) == tuple(sds.shape), name
