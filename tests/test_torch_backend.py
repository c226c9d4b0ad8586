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


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)])
def test_distributed_topk_decode_on_one_process(heads, use_kernel):
    """A B = 1 camformer decode with ``distributed_topk`` on one process
    (no ``torch.distributed`` group; no mesh in the reference) takes the
    local CAM search, as the reference does: within 1e-5 of the
    reference's output and equal to the port's own run with the flag
    off.  G = 1 and G = 2, the association stage in plain PyTorch and
    through the kernel wrappers (their plain versions on the CPU)."""
    n_heads, n_kv = heads
    kw = dict(attn_backend="camformer", n_heads=n_heads, n_kv_heads=n_kv,
              use_kernel=use_kernel)
    jcfg = j_smoke("mistral-nemo-12b", distributed_topk=True, **kw)
    tcfg = t_smoke("mistral-nemo-12b", distributed_topk=True, **kw)
    jb, tb = j_backend("camformer"), t_backend("camformer")
    from repro_torch.models import init_pools

    length, s, d = 48, 37, tcfg.head_dim
    rng = np.random.default_rng(n_kv * 2 + use_kernel)
    k, v = (rng.standard_normal((1, n_kv, s + 1, d)).astype(np.float32)
            for _ in range(2))
    q = rng.standard_normal((1, n_heads, 1, d)).astype(np.float32)
    jc = {name: jnp.zeros(spec[0].shape, spec[0].dtype) for name, spec in
          jb.cache_spec(jcfg, 1, length, jnp.float32).items()}
    jc = jb.write_cache(jc, jnp.asarray(k[:, :, :s]), jnp.asarray(v[:, :, :s]),
                        jnp.asarray(0, jnp.int32), jcfg)
    kv_len, pos = np.array([s + 1], np.int32), np.array([[s]], np.int32)
    j_out, _ = jb.decode(jnp.asarray(q), jc, jnp.asarray(k[:, :, s:]),
                         jnp.asarray(v[:, :, s:]), jnp.asarray(s, jnp.int32),
                         jnp.asarray(kv_len), jnp.asarray(pos), jcfg)

    def port(cfg):
        tc = init_pools([tb.cache_spec(cfg, 1, length, torch.float32)],
                        "cpu")[0]
        tc = tb.write_cache(tc, torch.from_numpy(k[:, :, :s]),
                            torch.from_numpy(v[:, :, :s]),
                            torch.tensor(0, dtype=torch.int32), cfg)
        out, _ = tb.decode(torch.from_numpy(q), tc,
                           torch.from_numpy(k[:, :, s:]),
                           torch.from_numpy(v[:, :, s:]),
                           torch.tensor(s, dtype=torch.int32),
                           torch.from_numpy(kv_len), torch.from_numpy(pos),
                           cfg)
        return out

    assert not torch.distributed.is_initialized()
    got = port(tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, port(tcfg.replace(distributed_topk=False)))
