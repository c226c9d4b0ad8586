"""The port's paged decode kernels, held against the JAX reference.

On the CPU each kernel wrapper takes its plain PyTorch version
(``repro_torch.kernels.ref``), which is compared with the reference's
jnp oracle (``repro.kernels.ref``) and with the reference's Pallas kernel
run through the Pallas interpreter (``interpret=True``).  The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there, and ``chip_smoke.py``
drives them at the serving shapes.

Tolerances: integer candidates bit-exact (indices only where the value
is valid: for a fully masked group the Pallas kernel writes base+0 twice
where ``lax.top_k`` writes base+0, base+1, and both are don't-care);
float rows to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bacam_decode as j_bdec
from repro.kernels import ops as j_ops
from repro.kernels import paged_flash_decode as j_pfd
from repro.kernels import ref as j_ref

from repro_torch.kernels import bacam_decode as t_bdec
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_flash_decode as t_pfd
from repro_torch.kernels import ref as t_ref

MASKED = j_ref.MASKED_SCORE


def _table(rng, b, np_, n_pages, kv_len, page):
    """Live entries on distinct non-trash pages, entries past kv_len on
    the trash page 0."""
    perm = rng.permutation(np.arange(1, n_pages))[: b * np_]
    table = perm.reshape(b, np_).astype(np.int32)
    for i, n in enumerate(kv_len):
        table[i, -(-int(n) // page):] = 0
    return table


def _bacam_inputs(seed, *, b=4, hkv=2, r=3, w=2, page=16, np_=4):
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * np_
    kv_len = np.array([np_ * page, 0, 23, 1][:b], np.int32)
    q = rng.integers(-2**31, 2**31, (b, hkv, r, w)).astype(np.int32)
    kp = rng.integers(-2**31, 2**31, (n_pages, hkv, page, w)).astype(np.int32)
    table = _table(rng, b, np_, n_pages, kv_len, page)
    q_pos = np.maximum(kv_len - 1, 0).astype(np.int32)
    return q, kp, table, kv_len, q_pos


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _u32(x):
    return jnp.asarray(x.view(np.uint32))


@pytest.mark.parametrize("group,s1,window", [(16, 2, None), (4, 2, None),
                                             (8, 3, 9), (16, 1, 5)])
def test_bacam_plain_matches_reference_and_pallas(group, s1, window):
    """Ragged kv_len (full table, inert 0, mid-page, 1), trash-page table
    entries, GQA R = 3 rows, with and without a window."""
    q, kp, table, kv_len, q_pos = _bacam_inputs(group * 10 + s1)
    d = 32 * q.shape[-1]
    before = t_bdec.launches
    tv, ti = t_bdec.bacam_paged_topk_stage1(
        *_t(q, kp, table, kv_len, q_pos), d=d, group=group, stage1_k=s1,
        window=window)
    assert t_bdec.launches == before  # the CPU path counts no launch
    jv, ji = j_ref.bacam_paged_topk_ref(
        _u32(q), _u32(kp), jnp.asarray(table), jnp.asarray(kv_len), d,
        q_pos=jnp.asarray(q_pos), group_size=group, stage1_k=s1,
        window=window)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pv, pi = j_bdec.bacam_paged_topk_stage1(
        _u32(q), _u32(kp), jnp.asarray(table), jnp.asarray(kv_len),
        jnp.asarray(q_pos), d=d, group=group, stage1_k=s1, window=window,
        interpret=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(pv))
    valid = np.asarray(pv) > MASKED // 2
    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(pi)[valid])


@pytest.mark.parametrize("case", ["ties", "masked groups"])
def test_bacam_plain_ties_and_masked_groups(case):
    """All-tie groups (every key of a group carries one key word) and fully
    masked groups (slots at kv_len 0 and 1, a window, GQA R = 4): the
    plain version against the jnp oracle on values and every index, fully
    masked groups at base + s, and against the Pallas kernel in interpret
    mode on values and valid indices (the Pallas body writes base + 0 for
    every candidate of a fully masked group, ROADMAP faults)."""
    q, kp, table, kv_len, q_pos = _bacam_inputs(len(case), r=4)
    group, s1, window = 8, 2, (None if case == "ties" else 6)
    if case == "ties":
        kp = np.repeat(kp[:, :, ::group], group, axis=2)
    d = 32 * q.shape[-1]
    tv, ti = t_bdec.bacam_paged_topk_stage1(
        *_t(q, kp, table, kv_len, q_pos), d=d, group=group, stage1_k=s1,
        window=window)
    tv, ti = tv.numpy(), ti.numpy()
    jargs = (_u32(q), _u32(kp), jnp.asarray(table), jnp.asarray(kv_len))
    jv, ji = j_ref.bacam_paged_topk_ref(
        *jargs, d, q_pos=jnp.asarray(q_pos), group_size=group, stage1_k=s1,
        window=window)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    v = tv.reshape(*tv.shape[:-1], -1, s1)
    dead = v[..., 0] == MASKED
    base = np.arange(v.shape[-2])[:, None] * group + np.arange(s1)
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(
        ti.reshape(v.shape)[dead], np.broadcast_to(base, v.shape)[dead])
    pv, pi = j_bdec.bacam_paged_topk_stage1(
        *jargs, jnp.asarray(q_pos), d=d, group=group, stage1_k=s1,
        window=window, interpret=True)
    np.testing.assert_array_equal(tv, np.asarray(pv))
    valid = tv > MASKED // 2
    np.testing.assert_array_equal(ti[valid], np.asarray(pi)[valid])


def test_build_path_covers_shared_headers(tmp_path, monkeypatch):
    """A library's path hashes its source, every csrc/*.cuh and the flags:
    an edited shared header gives both stage-1 sources a new library, an
    edited unrelated source leaves theirs alone."""
    from repro_torch.kernels import build

    for src in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    names = ("bacam_topk", "bacam_decode", "bacam_mvm")
    before = {n: build._lib_path(n) for n in names}
    header = tmp_path / "bacam_stage1.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: build._lib_path(n) for n in names}
    assert after["bacam_topk"] != before["bacam_topk"]
    assert after["bacam_decode"] != before["bacam_decode"]
    mvm = tmp_path / "bacam_mvm.cu"
    mvm.write_text(mvm.read_text() + "// edited\n")
    assert build._lib_path("bacam_topk") == after["bacam_topk"]
    assert build._lib_path("bacam_mvm") != after["bacam_mvm"]
    assert all(p.parent == build.BUILD_DIR for p in after.values())


def test_bacam_ops_wrapper_matches_reference():
    """NEG_INF conversion of masked candidates and the index clip."""
    q, kp, table, kv_len, q_pos = _bacam_inputs(7)
    d = 32 * q.shape[-1]
    tv, ti = t_ops.bacam_paged_scores_topk(*_t(q, kp, table, kv_len), d=d,
                                           group=4, stage1_k=2)
    jv, ji = j_ops.bacam_paged_scores_topk(
        _u32(q), _u32(kp), jnp.asarray(table), jnp.asarray(kv_len), d=d,
        group=4, stage1_k=2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    valid = np.asarray(jv) > -1e8
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    assert ti.max() <= table.shape[1] * kp.shape[2] - 1


def _flash_inputs(seed, *, b=3, hkv=2, g=4, sq=1, d=32, page=8, np_=4,
                  dtype=np.float32):
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * np_
    kv_len = np.array([2 * page, 0, 21], np.int32)[:b]
    q = rng.standard_normal((b, hkv, g * sq, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, hkv, page, d)).astype(dtype)
    v = rng.standard_normal((n_pages, hkv, page, d)).astype(dtype)
    table = _table(rng, b, np_, n_pages, kv_len, page)
    q_pos = np.maximum(kv_len - sq, 0).astype(np.int32)
    return q, k, v, table, kv_len, q_pos


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("binary,window", [(False, None), (True, None),
                                           (False, 5), (True, 7)])
def test_flash_plain_matches_reference_and_pallas(sq, binary, window):
    """Ragged kv_len incl. 0, trash pages, GQA G = 4 rows, sq > 1 per-row
    anchors, window and binary K; f32 pools, 1e-5."""
    q, k, v, table, kv_len, q_pos = _flash_inputs(sq * 7 + int(binary),
                                                  sq=sq)
    kw = dict(sq=sq, binary=binary, window=window)
    before = t_pfd.launches
    got = t_pfd.paged_flash_decode(*_t(q, k, v, table, kv_len, q_pos), **kw)
    assert t_pfd.launches == before
    jargs = [jnp.asarray(x) for x in (q, k, v, table, kv_len, q_pos)]
    want = j_ref.paged_flash_decode_ref(*jargs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pallas = j_pfd.paged_flash_decode(*jargs, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[1] == 0)  # kv_len == 0: zeros


def test_flash_plain_bf16_pools():
    """bf16 pools: both sides read the same bf16 values and compute in
    f32, so the f32 tolerance holds."""
    q, k, v, table, kv_len, q_pos = _flash_inputs(11)
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    got = t_pfd.paged_flash_decode(torch.from_numpy(q), tk, tv,
                                   *_t(table, kv_len, q_pos))
    want = j_ref.paged_flash_decode_ref(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16),
        *[jnp.asarray(x) for x in (table, kv_len, q_pos)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("page,np_,sq,g,window", [
    (128, 3, 1, 1, None), (128, 3, 40, 2, None), (256, 2, 1, 4, 100),
    (256, 2, 40, 1, 30)])
def test_flash_plain_large_pages(page, np_, sq, g, window):
    """Pages of 128 and 256 keys (``--page_size`` takes any multiple of the
    group size): keys start part-way into a page's 64-key tiles, and a
    slot ends one key into its last page."""
    rng = np.random.default_rng(page + sq)
    b, hkv, d = 3, 2, 32
    n_pages = 1 + b * np_
    kv_len = np.array([np_ * page, 0, page + 1], np.int32)
    q = rng.standard_normal((b, hkv, g * sq, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, hkv, page, d)).astype(np.float32)
    table = _table(rng, b, np_, n_pages, kv_len, page)
    q_pos = np.maximum(kv_len - sq, 0).astype(np.int32)
    kw = dict(sq=sq, window=window)
    got = t_pfd.paged_flash_decode(*_t(q, k, v, table, kv_len, q_pos), **kw)
    jargs = [jnp.asarray(x) for x in (q, k, v, table, kv_len, q_pos)]
    pallas = j_pfd.paged_flash_decode(*jargs, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[1] == 0)  # kv_len == 0: zeros


@pytest.mark.parametrize("sq", [1, 4])
def test_flash_ops_wrappers_match_reference(sq):
    """Query pre-scaling, temperature folding and the GQA row fold
    r = g * sq + s of ops.paged_flash_decode / paged_flash_prefill."""
    rng = np.random.default_rng(sq)
    b, hkv, g, d, page, np_ = 3, 2, 2, 32, 8, 4
    _, k, v, table, kv_len, _ = _flash_inputs(5 + sq, g=g, sq=sq)
    q = rng.standard_normal((b, hkv * g, sq, d)).astype(np.float32)
    temp = rng.uniform(0.5, 1.5, (b, hkv, g * sq)).astype(np.float32)
    q_pos = np.maximum(kv_len - sq, 0).astype(np.int32)
    t_fn = t_ops.paged_flash_decode if sq == 1 else t_ops.paged_flash_prefill
    j_fn = j_ops.paged_flash_decode if sq == 1 else j_ops.paged_flash_prefill
    for binary in (False, True):
        got = t_fn(*_t(q, k, v, table, kv_len, q_pos),
                   temp=torch.from_numpy(temp), binary=binary)
        want = j_fn(*[jnp.asarray(x) for x in (q, k, v, table, kv_len,
                                               q_pos)],
                    temp=jnp.asarray(temp), binary=binary)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(0)
    pages = rng.standard_normal((9, 2, 4, 3)).astype(np.float32)
    table = rng.integers(0, 9, (3, 5)).astype(np.int32)
    got = t_ref.paged_gather_ref(*_t(pages, table))
    want = j_ref.paged_gather_ref(jnp.asarray(pages), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
