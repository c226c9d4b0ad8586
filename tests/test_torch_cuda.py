"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test carries the ``gpu`` marker and skips without a card;
this file imports no JAX, so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: stage-1 candidates bit-exact (indices where the value is
valid: masked candidates' indices are don't-care), flash rows 1e-5 (both
sides compute in f32 from the same inputs; only the summation order
differs)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bacam_decode as bdec
from repro_torch.kernels import paged_flash_decode as pfd
from repro_torch.kernels.ref import MASKED_SCORE

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); "
                    "run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table(rng, b, np_, kv_len, page):
    """Live entries on distinct non-trash pages, the rest on page 0."""
    table = (1 + rng.permutation(b * np_)).reshape(b, np_).astype(np.int32)
    for i, n in enumerate(kv_len):
        table[i, -(-int(n) // page):] = 0
    return table


def _on(dev, *xs):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]


@pytest.mark.parametrize("r,w,page,group,s1,window", [
    (1, 2, 64, 16, 2, None), (3, 2, 16, 4, 2, None), (4, 4, 32, 8, 3, 9),
    (2, 1, 16, 16, 1, 5)])
def test_bacam_kernel_matches_plain(cuda, r, w, page, group, s1, window):
    rng = np.random.default_rng(page + r)
    b, hkv, np_ = 5, 3, 6
    kv_len = np.array([np_ * page, 0, page + 3, 1, 2 * page], np.int32)
    q = rng.integers(-2**31, 2**31, (b, hkv, r, w)).astype(np.int32)
    kp = rng.integers(-2**31, 2**31,
                      (1 + b * np_, hkv, page, w)).astype(np.int32)
    table = _table(rng, b, np_, kv_len, page)
    q_pos = np.maximum(kv_len - 1, 0).astype(np.int32)
    args = _on(cuda, q, kp, table, kv_len, q_pos)
    before = bdec.launches
    got_v, got_i = bdec.bacam_paged_topk_stage1(
        *args, d=32 * w, group=group, stage1_k=s1, window=window)
    want_v, want_i = bdec.bacam_paged_topk_ref(
        *args[:4], 32 * w, q_pos=args[4], group_size=group, stage1_k=s1,
        window=window)
    torch.cuda.synchronize()
    assert bdec.launches == before + 1
    assert torch.equal(got_v, want_v)
    valid = want_v > MASKED_SCORE // 2
    assert valid.any()
    assert torch.equal(got_i[valid], want_i[valid])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,sq,d,page,binary,window", [
    (1, 1, 64, 64, False, None), (4, 1, 32, 8, True, None),
    (2, 5, 128, 16, False, 7), (1, 40, 64, 64, False, None),
    (1, 8, 128, 64, False, None),  # f32: > 48 KiB of shared memory
    (4, 3, 32, 8, True, 6)])
def test_flash_kernel_matches_plain(cuda, dtype, g, sq, d, page, binary,
                                    window):
    rng = np.random.default_rng(sq * 10 + g)
    b, hkv, np_ = 4, 2, 5
    kv_len = np.array([np_ * page, 0, page + sq, 2 * page - 1], np.int32)
    kv_len = np.maximum(kv_len, np.where(kv_len > 0, sq, 0)).astype(np.int32)
    q = rng.standard_normal((b, hkv, g * sq, d)).astype(np.float32)
    k = rng.standard_normal((1 + b * np_, hkv, page, d)).astype(np.float32)
    v = rng.standard_normal((1 + b * np_, hkv, page, d)).astype(np.float32)
    table = _table(rng, b, np_, kv_len, page)
    q_pos = np.maximum(kv_len - sq, 0).astype(np.int32)
    qt, kt, vt, pt, kvl, qp = _on(cuda, q, k, v, table, kv_len, q_pos)
    kt, vt = kt.to(dtype), vt.to(dtype)
    kw = dict(sq=sq, binary=binary, window=window)
    before = pfd.launches
    got = pfd.paged_flash_decode(qt, kt, vt, pt, kvl, qp, **kw)
    want = pfd.paged_flash_decode_ref(qt, kt, vt, pt, kvl, qp, **kw)
    torch.cuda.synchronize()
    assert pfd.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.all(got[1] == 0)  # kv_len == 0: zeros


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 1, 1, 2), dtype=torch.int32, device=cuda)
    kp = torch.zeros((2, 1, 16, 2), dtype=torch.int32, device=cuda)
    pt = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    n = torch.ones((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # a CPU operand next to CUDA ones
        bdec.bacam_paged_topk_stage1(q, kp, pt.cpu(), n, n, d=64)
    with pytest.raises(ValueError):  # group not a power of two
        bdec.bacam_paged_topk_stage1(q, kp, pt, n, n, d=64, group=3)
    with pytest.raises(ValueError):  # f16 pools
        pfd.paged_flash_decode(q.float(), kp.half(), kp.half(), pt, n, n)
