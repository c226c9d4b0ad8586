"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test carries the ``gpu`` marker and skips without a card;
this file imports no JAX, so it runs where the card is:

    python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: integer scores, stage-1 candidates and bit-sliced products
bit-exact (candidate indices where the value is valid: masked
candidates' indices are don't-care), flash rows 1e-5 (both sides compute
in f32 from the same inputs; only the summation order differs), and
2**-7 for contiguous flash attention in bf16 (its output is rounded to
bf16)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bacam_decode as bdec
from repro_torch.kernels import bacam_mvm as bmvm
from repro_torch.kernels import bacam_topk as btk
from repro_torch.kernels import bitslice_vmm as bsv
from repro_torch.kernels import flash_attention as fla
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


def _assert_candidates(got_v, got_i, want_v, want_i, group, s1):
    """Values everywhere, indices everywhere (valid candidates, and the
    lowest masked indices the stable top-k picks), and base + s on every
    fully masked group, whose first candidate is masked."""
    assert torch.equal(got_v, want_v)
    valid = want_v > MASKED_SCORE // 2
    assert valid.any()
    assert torch.equal(got_i[valid], want_i[valid])
    assert torch.equal(got_i, want_i)
    v = got_v.reshape(*got_v.shape[:-1], -1, s1)
    i = got_i.reshape(v.shape)
    dead = v[..., 0] == MASKED_SCORE
    base = (torch.arange(v.shape[-2], device=v.device, dtype=torch.int32)
            * group)[:, None] + torch.arange(s1, device=v.device,
                                             dtype=torch.int32)
    assert torch.equal(i[dead], base.expand_as(i)[dead])


@pytest.mark.parametrize("r,w,page,group,s1,window,ties", [
    (1, 2, 64, 16, 2, None, False), (3, 2, 16, 4, 2, None, False),
    (4, 4, 32, 8, 3, 9, False), (2, 1, 16, 16, 1, 5, False),
    (8, 2, 64, 16, 2, 100, False),  # GQA rows (R = G = 8), window
    (1, 2, 128, 16, 2, None, False),  # 128-key pages, group 16
    (8, 2, 64, 16, 2, None, True),  # one key word per group: all ties
    (2, 2, 64, 32, 32, None, False),  # stage1_k = group = 32
    # the shapes' other instances: a thread per group at group 2 and 1,
    # and 4 rows a thread past 8 rows (at W = 5 too)
    (2, 2, 16, 2, 2, None, False), (3, 1, 16, 1, 1, 5, False),
    (16, 2, 64, 16, 2, None, False), (12, 5, 32, 8, 2, 9, False),
    # granite-moe-3b-a800m's decode rows: G = 3 on 64-key pages, d = 64
    (3, 2, 64, 16, 2, None, False), (3, 2, 64, 16, 2, 100, False),
    # the assigned LMs' head_dim 128 (W = 4) on 64-key pages, group 16:
    # yi-34b's G = 7, mistral-nemo-12b's and llava's G = 4 and the G = 1
    # rows of codeqwen1.5-7b and moonshot-v1-16b-a3b (MHA)
    (7, 4, 64, 16, 2, None, False), (4, 4, 64, 16, 2, None, False),
    (1, 4, 64, 16, 2, None, False)])
def test_bacam_kernel_matches_plain(cuda, r, w, page, group, s1, window,
                                    ties):
    """Ragged and inert slots, table entries past kv_len on the trash
    page 0 and one entry past the pool (clamped)."""
    rng = np.random.default_rng(page + r)
    b, hkv, np_ = 5, 3, 6
    kv_len = np.array([np_ * page, 0, page + 3, 1, 2 * page], np.int32)
    q = rng.integers(-2**31, 2**31, (b, hkv, r, w)).astype(np.int32)
    kp = rng.integers(-2**31, 2**31,
                      (1 + b * np_, hkv, page, w)).astype(np.int32)
    if ties:  # every key of a group carries its group's first key's words
        kp = np.repeat(kp[:, :, ::group], group, axis=2)
    table = _table(rng, b, np_, kv_len, page)
    table[4, -1] = 10**6  # past kv_len and past the pool
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
    _assert_candidates(got_v, got_i, want_v, want_i, group, s1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,sq,d,page,binary,window,np_,lens", [
    (1, 1, 64, 64, False, None, 5, None), (4, 1, 32, 8, True, None, 5, None),
    (2, 5, 128, 16, False, 7, 5, None), (1, 40, 64, 64, False, None, 5, None),
    (1, 8, 128, 64, False, None, 5, None),  # f32: > 48 KiB of shared memory
    (4, 3, 32, 8, True, 6, 5, None),
    # the split-KV decode and tensor-core chunk designs' edges
    (1, 1, 64, 16, False, None, 64, (1000, 0, 17, 1)),  # many splits
    (1, 1, 64, 64, False, None, 5, (129, 0, 65, 1)),  # one key into a page
    (1, 16, 64, 64, False, None, 5, (129, 0, 65, 17)),
    (8, 1, 64, 64, False, None, 5, None),  # G = 8 decode rows
    (8, 1, 128, 16, True, 20, 8, (100, 0, 33, 128)),
    (1, 384, 64, 64, False, None, 7, (64, 0, 200, 384)),  # padding rows
    (1, 1, 64, 16, False, 24, 8, (100, 0, 40, 17)),  # window over splits
    (2, 40, 64, 64, True, None, 5, None),  # binary K, chunk rows
    (1, 1, 64, 64, True, None, 5, None),
    # pages past one 64-key tile: a tile or split starts inside a page
    (1, 1, 64, 128, False, None, 4, (300, 0, 129, 1)),
    (1, 40, 64, 128, False, None, 4, (300, 0, 129, 17)),
    (4, 1, 64, 256, False, 100, 3, (600, 0, 257, 1)),
    (2, 40, 64, 256, True, 30, 3, (600, 0, 257, 64)),
    # granite-moe-3b-a800m's G = 3 (d = 64): decode rows (dense and
    # binary), a verify chunk and a prefill chunk with padding rows
    (3, 1, 64, 64, False, None, 16, (1000, 0, 65, 1)),
    (3, 1, 64, 64, True, None, 16, (1000, 0, 65, 1)),
    (3, 4, 64, 64, False, None, 16, None),
    (3, 384, 64, 64, False, None, 7, (64, 0, 200, 384)),
    # yi-34b's G = 7 at D = Dv = 128: decode rows (split-KV in bf16) and
    # a 384-token prefill chunk of 7 x 384 rows (chunk tiles in bf16);
    # the same at mistral-nemo-12b's and llava's G = 4 and at the G = 1
    # of codeqwen1.5-7b and moonshot-v1-16b-a3b
    (7, 1, 128, 64, False, None, 16, (1000, 0, 65, 1)),
    (7, 384, 128, 64, False, None, 7, (64, 0, 200, 384)),
    (4, 1, 128, 64, False, None, 16, (1000, 0, 65, 1)),
    (4, 384, 128, 64, False, None, 7, (64, 0, 200, 384)),
    (1, 1, 128, 64, False, None, 16, (1000, 0, 65, 1)),
    (1, 384, 128, 64, False, None, 7, (64, 0, 200, 384))])
def test_flash_kernel_matches_plain(cuda, dtype, g, sq, d, page, binary,
                                    window, np_, lens):
    rng = np.random.default_rng(sq * 10 + g)
    b, hkv = 4, 2
    if lens is None:
        kv_len = np.array([np_ * page, 0, page + sq, 2 * page - 1], np.int32)
        kv_len = np.maximum(kv_len, np.where(kv_len > 0, sq, 0))
    else:  # chunk rows past a short kv_len are padding rows
        kv_len = np.array(lens)
    kv_len = kv_len.astype(np.int32)
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


def _ws(n_splits, rows, dv):  # split workspace floats at B = 2, H_kv = 3
    return 2 * 3 * n_splits * rows * (dv + 2)


@pytest.mark.parametrize("args,split_pages,design,ws", [
    # camformer-bert's decode step and prefill chunk (d 64, 64-key pages)
    ((1, 64, 64, 64, 16, 1, True), 1, "split-KV", _ws(16, 1, 64)),
    ((384, 64, 64, 64, 16, 384, True), 1, "chunk tiles", 0),
    ((8, 128, 128, 16, 64, 1, True), 1, "split-KV", _ws(64, 8, 128)),  # G 8
    ((9, 128, 128, 16, 64, 1, True), 1, "chunk tiles", 0),  # > 8 rows
    ((9, 64, 64, 64, 16, 1, False), 1, "SIMT", 0),
    ((12, 64, 64, 64, 16, 3, False), 1, "SIMT", 0),  # f32 chunk rows
    ((12, 32, 32, 8, 4, 3, True), 1, "SIMT", 0),  # 8-key pages
    ((12, 256, 256, 64, 4, 3, True), 1, "SIMT", 0),  # D > 128
    ((12, 64, 64, 128, 4, 3, True), 1, "chunk tiles", 0),
    ((12, 64, 64, 96, 4, 3, True), 1, "SIMT", 0),  # 96-key pages
    ((1, 48, 48, 64, 4, 1, True), 1, "SIMT", 0),  # 6 chunks a row
    ((4, 256, 256, 64, 4, 1, False), 1, "split-KV", _ws(4, 4, 256)),
    ((1, 256, 256, 256, 4, 1, False), 1, "SIMT", 0),  # > 227 KB
    ((2, 64, 64, 128, 5, 1, True), 1, "split-KV", _ws(5, 2, 64)),
    ((1, 64, 64, 64, 15, 1, True), 2, "split-KV", _ws(8, 1, 64)),
    ((1, 256, 256, 64, 8, 1, False), 2, "SIMT", 0),  # 2 pages too large
    # yi-34b (G = 7, D = 128) on 64-key pages x 16: the decode step and
    # the 384-token prefill chunk (7 x 384 rows), in the parity cases above
    ((7, 128, 128, 64, 16, 1, True), 1, "split-KV", _ws(16, 7, 128)),
    ((7 * 384, 128, 128, 64, 16, 384, True), 1, "chunk tiles", 0)])
def test_flash_plan_picks_design(cuda, args, split_pages, design, ws):
    """The source's choice among its three designs, from the shapes (rows,
    D, Dv, page, NP, sq, bf16) alone, and the workspace it asks for."""
    got, got_ws = pfd.plan(2, 3, *args, split_pages=split_pages)
    assert (pfd.DESIGNS[got], got_ws) == (design, ws)


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


# --- the contiguous-path kernels -------------------------------------------

# ragged rows and keys on both sides of the design switch: R < 64 and Skv
# < 32 (popc), R = 1, R a ragged multiple of the 64-row tile (tensor cores),
# 6000-byte rows (no whole number of 128-byte lines: the line-owning
# stores) and rows of odd length (no 16-byte alignment)
MVM_SHAPES = [(3, 37, 100), (1, 1, 20), (2, 129, 257), (2, 96, 1500),
              (1, 64, 66)]


@pytest.mark.parametrize("w", range(1, 9))
@pytest.mark.parametrize("b,r,skv", MVM_SHAPES)
def test_mvm_kernel_matches_plain(cuda, b, r, skv, w):
    """The public entry (one launch, the design the source picks) and
    every design by name, bit-exact at every W."""
    rng = np.random.default_rng(r + skv + w)
    q, k = _on(cuda, rng.integers(-2**31, 2**31, (b, r, w)).astype(np.int32),
               rng.integers(-2**31, 2**31, (b, skv, w)).astype(np.int32))
    before = bmvm.launches
    got = bmvm.bacam_mvm(q, k, d=32 * w)
    want = bmvm.bacam_scores_ref(q, k, 32 * w)
    torch.cuda.synchronize()
    assert bmvm.launches == before + 1
    assert torch.equal(got, want)
    for design in range(len(bmvm.DESIGNS)):
        got = bmvm.launch(q, k, d=32 * w, design=design)
        torch.cuda.synchronize()
        assert torch.equal(got, want), bmvm.DESIGNS[design]
    assert bmvm.launches == before + 1


def test_mvm_kernel_picks_both_designs(cuda):
    """The source's rule: popc below a 64-row tile (a decode step, R = 1,
    up to R = 63), the tensor cores from 64 rows, with the s8 product up
    to W = 2 and the b1 product above."""
    for w in range(1, 9):
        product = "tensor cores s8" if w <= 2 else "tensor cores b1"
        assert [bmvm.DESIGNS[bmvm.plan(r, w)] for r in (1, 63, 64, 20160)] \
            == ["popc", "popc", product, product]


@pytest.mark.parametrize("r,skv,w,group,s1,causal,window,lens,ties", [
    (1, 1024, 2, 16, 2, True, None, None, False),
    (24, 96, 2, 8, 1, True, 8, None, False),
    (5, 100, 4, 4, 4, False, None, None, False),
    (130, 300, 2, 16, 2, True, None, None, False),
    (3, 37, 8, 32, 3, True, 5, None, False),
    # the first 128-row chunk of a prefill: q_pos 0..127, kv_len 128, so
    # seven eighths of the key tiles are masked for every row
    (128, 1024, 2, 16, 2, True, None, (128, 128, 128, 0), False),
    (24, 96, 2, 16, 2, True, None, None, True),  # all ties in a group
    (9, 200, 2, 32, 32, True, None, None, False),  # stage1_k = group = 32
    (7, 100, 3, 32, 32, False, 20, None, True),
    # a thread per group at group 2 and 1 (at most 8 rows)
    (6, 50, 2, 2, 2, True, None, None, False),
    (3, 40, 1, 1, 1, True, 7, None, False)])
def test_topk_kernel_matches_plain(cuda, r, skv, w, group, s1, causal,
                                   window, lens, ties):
    rng = np.random.default_rng(r * 7 + skv)
    b = 4
    q = rng.integers(-2**31, 2**31, (b, r, w)).astype(np.int32)
    k = rng.integers(-2**31, 2**31, (b, skv, w)).astype(np.int32)
    if ties:  # every key of a group carries its group's first key's words
        k = np.repeat(k[:, ::group], group, axis=1)[:, :skv]
    if lens is None:
        kv_len = np.array([skv, 0, skv // 2 + 1, 1], np.int32)
        q_pos = (np.arange(r, dtype=np.int32)[None] + kv_len[:, None]
                 - r).clip(0).astype(np.int32)
    else:  # a chunk at positions 0..r-1
        kv_len = np.array(lens, np.int32)
        q_pos = np.tile(np.arange(r, dtype=np.int32), (b, 1))
    args = _on(cuda, q, k, q_pos, kv_len)
    kw = dict(d=32 * w, group=group, stage1_k=s1, causal=causal,
              window=window)
    before, chunks = btk.launches, btk.prefill_launches
    got_v, got_i = btk.bacam_topk_stage1(*args, **kw)
    want_v, want_i = btk.bacam_topk_stage1_plain(*args, **kw)
    torch.cuda.synchronize()
    assert btk.launches == before + 1
    assert btk.prefill_launches == chunks + (r > 1)
    _assert_candidates(got_v, got_i, want_v, want_i, group, s1)


CANARY = 0x5A5A5A5A


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("r,group,s1", [
    (1, 16, 2), (16, 16, 2), (3, 2, 2), (2, 8, 3)])
def test_stage1_writes_stay_in_bounds(cuda, paged, r, group, s1):
    """Each variant of the two stage-1 entries (4 lanes a group, 4 rows a
    thread, a thread per group, the generic stage1_k > 2 path) writes its
    candidates and no word around them: the C entry is called with its
    outputs placed between canary words of one buffer."""
    from repro_torch.kernels import build

    rng = np.random.default_rng(r * 31 + group)
    b, h, w, page, np_ = 3, 2, 2, 32, 4
    kv_len = np.array([np_ * page, 5, 0], np.int32)
    q = rng.integers(-2**31, 2**31, (b, h, r, w)).astype(np.int32)
    q_pos = np.maximum(kv_len - 1, 0).astype(np.int32)
    kw = dict(d=32 * w, group=group, stage1_k=s1)
    if paged:
        kp = rng.integers(-2**31, 2**31,
                          (1 + b * np_, h, page, w)).astype(np.int32)
        args = _on(cuda, q, kp, _table(rng, b, np_, kv_len, page), kv_len,
                   q_pos)
        want = bdec.bacam_paged_topk_stage1(*args, **kw)
        fn = build.entry("bacam_decode", "bacam_paged_topk_stage1", 7, 12)
        ints = (b, h, r, w, kp.shape[0], page, np_, 32 * w, group, s1, 0, 0)
    else:
        rows = np.repeat(q_pos, h)[:, None] + np.arange(r) - (r - 1)
        args = _on(cuda, q.reshape(b * h, r, w),
                   rng.integers(-2**31, 2**31,
                                (b * h, np_ * page, w)).astype(np.int32),
                   rows.clip(0).astype(np.int32), np.repeat(kv_len, h))
        want = btk.bacam_topk_stage1(*args, **kw)
        fn = build.entry("bacam_topk", "bacam_topk_stage1", 6, 10)
        ints = (b * h, r, np_ * page, w, 32 * w, group, s1, 1, 0, 0)
    n, pad = want[0].numel(), 1024
    buf = torch.full((2, pad + n + pad), CANARY, dtype=torch.int32,
                     device=cuda)
    vals, idx = buf[0, pad:pad + n], buf[1, pad:pad + n]
    err = fn(*(t.data_ptr() for t in args), vals.data_ptr(), idx.data_ptr(),
             *ints, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (buf[:, :pad] == CANARY).all()
    assert (buf[:, pad + n:] == CANARY).all()
    assert torch.equal(vals, want[0].reshape(-1))
    assert torch.equal(idx, want[1].reshape(-1))


@pytest.mark.parametrize("bits,b,r,n,d", [
    (1, 2, 17, 33, 64), (2, 2, 17, 33, 64), (4, 2, 17, 33, 64),
    (8, 2, 17, 33, 64), (8, 1, 64, 128, 32), (8, 3, 65, 129, 256),
    (12, 2, 70, 200, 96), (16, 1, 130, 257, 256), (24, 2, 33, 50, 64),
    (4, 1, 1, 1, 32)])
def test_bitslice_kernel_one_launch_matches_plain(cuda, bits, b, r, n, d):
    """One kernel launch and no BA-CAM launch per call, bit-exact.  w at
    both ends of its range against an all +1 row gives the largest sums
    of the case, all under 2**31 (the float64 plain version converts to
    int32 exactly only there; the kernel wraps)."""
    rng = np.random.default_rng(bits * 1000 + r + n)
    x = np.where(rng.standard_normal((b, r, d)) > 0, 1.0, -1.0)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    w = rng.integers(lo, hi, (b, n, d))
    x[:, 0] = 1.0
    w[:, 0] = lo
    w[:, -1] = hi - 1
    xt, wt = _on(cuda, x.astype(np.float32), w.astype(np.int32))
    before, mvm_before = bsv.launches, bmvm.launches
    got = bsv.bitslice_vmm(xt, wt, bits=bits)
    want = bsv.bitslice_vmm_ref(xt, wt, bits)
    torch.cuda.synchronize()
    assert bsv.launches == before + 1
    assert bmvm.launches == mvm_before
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,d,causal,off,win", [
    (2, 64, 64, 64, True, 0, None), (1, 128, 128, 32, True, 0, 48),
    (2, 16, 128, 64, True, 112, None), (1, 64, 128, 64, False, 0, None),
    (3, 50, 77, 128, True, 27, None),  # ragged; > 48 KiB shared memory
    (1, 20, 40, 96, False, 0, 7), (2, 9, 33, 256, True, 24, 5),
    (1, 8, 20, 32, True, 16, None),  # rows past Skv: keys >= Skv masked
    # the tile edges: Sq = 1, Sq and Skv off the 64/128-row and 64-key
    # tiles, D = 32, 96, 256 and one the wrapper pads (20), windows
    (1, 1, 64, 64, True, 63, None), (2, 1, 300, 256, True, 299, None),
    (2, 130, 200, 64, True, 70, None), (1, 70, 70, 32, False, 0, None),
    (2, 100, 150, 96, True, 50, 33), (1, 129, 129, 256, True, 0, None),
    (1, 33, 300, 128, False, 0, 64), (2, 40, 30, 64, True, 10, None),
    (1, 10, 24, 20, True, 14, None), (2, 300, 700, 64, True, 400, 200)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, sq, skv, d,
                                              causal, off, win):
    """Every row sees a key (where none does, the kernel writes zeros and
    the naive plain version a uniform average).  f32 to 1e-5; bf16 to
    2**-7 (rel + abs): both round an f32 result to bf16, and a different
    f32 summation order can move it by one bf16 step."""
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = _on(cuda, *(rng.standard_normal((b, n, d)).astype(np.float32)
                          for n in (sq, skv, skv)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kw = dict(causal=causal, window=win)
    before = fla.launches
    got = fla.flash_attention(q, k, v, off, **kw)
    want = fla.flash_attention_ref(q, k, v, q_offset=off, **kw)
    torch.cuda.synchronize()
    assert fla.launches == before + 1
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_contiguous_path_launches_kernels_never_plain(cuda, monkeypatch):
    """use_kernel=True on CUDA tensors: whole prefill launches the BA-CAM
    matrix kernel once per layer, chunks and decode steps the top-k kernel
    once per layer (``prefill_launches`` counts the chunks alone, also
    with GQA rows folded), and no plain version runs."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import (init_params, init_pools, lm_cache_specs,
                                    lm_decode, lm_prefill)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(bmvm, "bacam_scores_ref", plain)
    monkeypatch.setattr(btk, "bacam_topk_stage1_plain", plain)
    for chunk, n_kv in ((0, 4), (4, 4), (4, 2)):  # 2: GQA rows, G = 2
        cfg = smoke_config("camformer-bert", use_kernel=True,
                           prefill_chunk=chunk, n_kv_heads=n_kv)
        params = init_params(cfg, device=cuda, seed=0)
        caches = init_pools(lm_cache_specs(cfg, 2, 16), cuda)
        tokens = torch.randint(0, cfg.vocab, (2, 8), device=cuda)
        mvm0, topk0 = bmvm.launches, btk.launches
        chunks0 = btk.prefill_launches
        logits, caches = lm_prefill(params, {"tokens": tokens}, caches, cfg)
        n = cfg.n_layers
        assert bmvm.launches - mvm0 == (0 if chunk else n)
        assert btk.launches - topk0 == (2 * n if chunk else 0)
        assert btk.prefill_launches - chunks0 == (2 * n if chunk else 0)
        pos = torch.full((2,), 8, dtype=torch.int32, device=cuda)
        for _ in range(3):
            logits, caches = lm_decode(params, logits.argmax(-1), pos,
                                       pos + 1, caches, cfg)
            pos = pos + 1
        torch.cuda.synchronize()
        assert btk.launches - topk0 == (2 * n if chunk else 0) + 3 * n
        # decode rows hold one position each, also with GQA rows folded
        assert btk.prefill_launches - chunks0 == (2 * n if chunk else 0)
        assert torch.isfinite(logits).all()


def test_apply_moe_on_card_equals_cpu(cuda):
    """One granite-moe-3b-a800m MoE layer at full width (d 1536, 40 of 48
    experts, top-8, d_ff 512; f32 weights) on the card against the CPU:
    routing (experts, buffer positions, keep mask) identical, outputs
    within 1e-5, aux values within 1e-6, at one group (8 tokens) and at
    eight (8 x 64)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M

    cfg = get_config("granite-moe-3b-a800m", dtype="float32")
    gen = torch.Generator().manual_seed(1)
    p = {name: torch.randn(shape, generator=gen) * shape[-2]**-0.5
         for name, (shape, *_) in M.moe_shapes(cfg).items()}
    pc = {k: v.to(cuda) for k, v in p.items()}
    for b, s in ((8, 1), (8, 64)):
        x = torch.randn((b, s, cfg.d_model), generator=gen)
        gt = M.group_size(b * s)
        cap = M.capacity(cfg, gt)
        want_r = M.route(p["router"], x.reshape(-1, gt, cfg.d_model), cfg,
                         cap)
        got_r = M.route(pc["router"],
                        x.to(cuda).reshape(-1, gt, cfg.d_model), cfg, cap)
        for name in ("eidx", "pos", "keep"):
            assert torch.equal(getattr(got_r, name).cpu(),
                               getattr(want_r, name)), name
        got, got_aux = M.apply_moe(pc, x.to(cuda), cfg)
        want, want_aux = M.apply_moe(p, x, cfg)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        for k in want_aux:
            torch.testing.assert_close(got_aux[k].cpu(), want_aux[k],
                                       rtol=1e-6, atol=1e-6)


def test_granite_smoke_paged_logits_on_card_equal_cpu(cuda):
    """Smoke granite-moe-3b-a800m at G = 3 (6 heads on 2 kv heads, 8
    experts padded to 48), f32: paged prefill and 3 decode steps on the
    card (the paged kernels) against the CPU (their plain versions), both
    fed the CPU's picks: logits within 1e-4, on dense and camformer."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import (cast_params, init_params, init_pools,
                                    lm_decode_paged, lm_page_specs,
                                    lm_prefill_paged)

    b, s, page, np_ = 3, 20, 8, 6
    table = torch.from_numpy(
        (1 + np.arange(b * np_, dtype=np.int32)).reshape(b, np_))
    lens = torch.tensor([20, 13, 0], dtype=torch.int32)
    live = lens > 0
    for backend in ("dense", "camformer"):
        cfg = smoke_config("granite-moe-3b-a800m", attn_backend=backend,
                           n_heads=6, n_kv_heads=2)
        params = init_params(cfg, device="cpu", seed=0)
        tokens = torch.randint(0, cfg.vocab, (b, s),
                               generator=torch.Generator().manual_seed(2))
        out, fed = {}, []
        for dev in (torch.device("cpu"), cuda):
            p = cast_params(params, torch.float32, dev)
            pools = init_pools(lm_page_specs(cfg, 1 + b * np_, page, b), dev)
            pt = table.to(dev)
            lg, pools = lm_prefill_paged(
                p, {"tokens": tokens.to(dev), "lens": lens.to(dev)}, pools,
                pt, cfg)
            logits, pos = [lg], lens.to(dev)
            for step in range(3):
                if dev.type == "cpu":
                    fed.append(logits[-1].argmax(-1).to(torch.int32))
                kvl = (pos + 1) * live.to(dev)
                lg, pools = lm_decode_paged(p, fed[step].to(dev), pos, kvl,
                                            pools, pt, cfg)
                logits.append(lg)
                pos = pos + live.to(dev)
            out[dev.type] = torch.stack(logits).cpu()
        torch.testing.assert_close(out["cuda"][:, live], out["cpu"][:, live],
                                   rtol=1e-4, atol=1e-4)


def test_keyed_draws_on_card_equal_cpu(cuda):
    """The keyed sampler on a CUDA logits tensor gives the draws (and the
    threefry bits) of the same call on its CPU copy."""
    from repro_torch.serving import prng
    from repro_torch.serving import sampler as S

    rng = np.random.default_rng(0)
    b, v = 16, 30522
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    keys = rng.integers(0, 2**32, (b, 2), dtype=np.uint64).astype(np.int64)
    idx = rng.integers(0, 1000, b).astype(np.int32)
    temps = np.where(np.arange(b) % 4 == 1, 0.0, 0.9).astype(np.float32)
    top_ks = rng.choice([0, 1, 40], b).astype(np.int32)
    top_ps = rng.choice([1.0, 0.95], b).astype(np.float32)
    args = [torch.from_numpy(x) for x in (logits, keys, idx, temps, top_ks,
                                          top_ps)]
    want = S.sample_step_keyed(*args)
    got = S.sample_step_keyed(*[x.to(cuda) for x in args])
    assert torch.equal(got.cpu(), want)
    fold = prng.fold_in(args[1], args[2])
    assert torch.equal(prng.random_bits(fold.to(cuda), v).cpu(),
                       prng.random_bits(fold, v))


def _stateful_pools(rng, backend, n_pages, hkv, page, d, b, spec_k):
    pools = {"v_pages": rng.standard_normal((n_pages, hkv, page, d)),
             "k_scale": rng.uniform(0.5, 1.5, (b, hkv))}
    if backend in ("binary", "hybrid"):
        pools["k_pages"] = rng.standard_normal((n_pages, hkv, page, d))
    if backend == "hybrid":
        pools["kp_pages"] = rng.integers(-2**31, 2**31,
                                         (n_pages, hkv, page, d // 32))
    if spec_k:
        pools["k_means"] = np.zeros((b, hkv, spec_k + 1))
    return {k: torch.from_numpy(x.astype(np.int32 if k == "kp_pages"
                                         else np.float32))
            for k, x in pools.items()}


@pytest.mark.parametrize("backend", ["binary", "hybrid"])
@pytest.mark.parametrize("sq,verify", [(1, False), (12, False), (4, True)])
def test_stateful_paged_decode_on_card_matches_plain(cuda, backend, sq,
                                                     verify):
    """``paged_decode`` of ``binary`` and ``hybrid`` on the card (the
    kernels) against the same call on the CPU (the plain versions):
    outputs and float pools within 1e-5, packed keys bit-exact, and the
    launch went to the kernel the path names."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.backend import get_backend

    spec_k = 3 if verify else 0
    cfg = smoke_config("mistral-nemo-12b", attn_backend=backend, n_heads=4,
                       n_kv_heads=2, spec_k=spec_k, spec_verify=verify)
    b, hkv, h, d, page, np_ = 4, 2, 4, 32, 8, 5
    n_pages = 1 + b * np_
    rng = np.random.default_rng(sq)
    pools = _stateful_pools(rng, backend, n_pages, hkv, page, d, b, spec_k)
    table = _table(rng, b, np_, [40] * 3 + [0], page)
    offsets = np.array([0, 4, 8, 0], np.int32) if sq > 1 else \
        np.array([11, 20, 7, 0], np.int32)
    kv_len = np.where(np.arange(b) < 3, offsets + sq, 0).astype(np.int32)
    kv_len[1] -= sq // 2  # padding rows past kv_len
    pos = (offsets[:, None] + np.arange(sq)[None]).astype(np.int32)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    bk = get_backend(backend)
    outs = {}
    counts = (pfd.launches, pfd.prefill_launches, pfd.binary_launches,
              bdec.launches)
    for dev in ("cpu", cuda):
        p = {name: x.clone().to(dev) for name, x in pools.items()}
        out, p = bk.paged_decode(
            *_on(dev, q), p, *_on(dev, k, v, pos, table, kv_len), cfg,
            base=torch.zeros(b, dtype=torch.int32, device=dev))
        outs[str(dev)] = (out.cpu(), {n: x.cpu() for n, x in p.items()})
    torch.cuda.synchronize()
    (cpu_out, cpu_p), (dev_out, dev_p) = outs["cpu"], outs[str(cuda)]
    live = torch.zeros((b, h, sq), dtype=torch.bool)
    for i in range(b):
        live[i, :, : max(0, int(kv_len[i] - offsets[i]))] = True
    torch.testing.assert_close(dev_out[live], cpu_out[live], rtol=1e-5,
                               atol=1e-5)
    for name, x in cpu_p.items():
        if name == "kp_pages":
            assert torch.equal(dev_p[name][1:], x[1:])
        elif name.endswith("_pages"):
            torch.testing.assert_close(dev_p[name][1:], x[1:])
        else:
            torch.testing.assert_close(dev_p[name], x, rtol=1e-5, atol=1e-6)
    flash, chunk, binary, cam = (now - then for now, then in zip(
        (pfd.launches, pfd.prefill_launches, pfd.binary_launches,
         bdec.launches), counts))
    if backend == "binary":  # every row through the flash kernel
        assert (flash, chunk, binary, cam) == (1, sq > 1, sq == 1, 0)
    elif sq == 1:  # hybrid decode rows: the CAM kernel
        assert (flash, cam) == (0, 1)
    else:  # hybrid chunks: flash-scored; verify chunks: CAM, gathered
        assert (flash, chunk, binary, cam) == ((0, 0, 0, 0) if verify
                                               else (1, 1, 0, 0))


def test_spec_engine_launch_counts_exact(cuda, monkeypatch):
    """A small speculative engine on the card (dense target, binary
    drafter, spec_k = 2, temperature 0.9): every decode tick launches the
    binary decode kernel m = 3 times and the verify chunk once per layer,
    each prefill tick one chunk per layer for each stack, no plain
    version runs, and the streams equal plain decode's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, SamplingParams, ServeEngine

    cfg = smoke_config("camformer-bert", attn_backend="dense")
    params = init_params(cfg, device=cuda, seed=0)
    streams = {}
    for spec_k in (2, 0):
        eng = ServeEngine(cfg, params, max_batch=3, max_len=64, page_size=8,
                          mode="overlap", spec_k=spec_k, device=cuda)
        reqs = [Request(prompt=[5 + i, 9, 2, 4 + i, 7][: 3 + i],
                        sampling=SamplingParams(max_new=9, temperature=0.9,
                                                top_k=40), rid=i)
                for i in range(3)]
        if spec_k:
            def plain(*a, **k):
                raise AssertionError("a plain version ran on the card")

            monkeypatch.setattr(pfd, "paged_flash_decode_ref", plain)
        before = (pfd.launches, pfd.binary_launches, pfd.sq_launches[3],
                  pfd.prefill_launches)
        for _ in eng.stream(*reqs):
            pass
        monkeypatch.undo()
        torch.cuda.synchronize()
        streams[spec_k] = [r.tokens for r in reqs]
        if not spec_k:
            continue
        n, m = cfg.n_layers, spec_k + 1
        flash, binary, verify, chunks = (now - then for now, then in zip(
            (pfd.launches, pfd.binary_launches, pfd.sq_launches[3],
             pfd.prefill_launches), before))
        assert eng.tick_errors == 0, eng.last_error
        assert binary == eng.ticks * m * n
        assert verify == eng.ticks * n
        assert chunks == verify + 2 * eng.prefill_ticks * n
        assert flash == binary + chunks
        assert eng.readbacks == eng.ticks + eng.prefill_ticks
        assert 0 < eng.spec_accepted <= eng.spec_proposed
    assert streams[2] == streams[0]


# --- the training path -----------------------------------------------------

def test_sign_ste_on_card_equals_cpu(cuda):
    """The straight-through sign: forward and gradient bit-equal on the
    card and the CPU (|x| <= 1 passes the gradient, zero maps to -1)."""
    from repro_torch.core.binarize import sign_ste

    gen = torch.Generator().manual_seed(3)
    x = torch.cat([torch.rand(997, generator=gen) * 4 - 2,
                   torch.tensor([0.0, 1.0, -1.0])])
    w = torch.randn(x.shape, generator=gen)
    out = []
    for dev in ("cpu", cuda):
        xd = x.detach().to(dev).requires_grad_()
        y = sign_ste(xd)
        (y * w.to(dev)).sum().backward()
        out.append((y.detach().cpu(), xd.grad.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][1], w * (x.abs() <= 1.0))


def test_mvm_kernel_at_the_training_shape(cuda):
    """Kernel 4 at the camformer-bert train step: 8 x 16 (b, kv head)
    rows, R = Skv = 1024, d = 64 (W = 2), bit-exact, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k = (torch.randint(-2**31, 2**31 - 1, (128, 1024, 2), generator=gen,
                          device=cuda, dtype=torch.int32) for _ in range(2))
    before = bmvm.launches
    got = bmvm.bacam_mvm(q, k, d=64)
    want = bmvm.bacam_scores_ref(q, k, 64)
    torch.cuda.synchronize()
    assert bmvm.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,r,skv,w", [
    (1, 2016, 2016, 8),  # recurrentgemma prefill, one (b, kv head) of G=10
    (2, 1500, 1500, 2),  # whisper's non-causal encoder: 1500 keys
    (64, 32, 1500, 2),  # whisper cross-attention at prefill
    (64, 1, 1500, 2),  # and at a decode step: R = 1
    (16, 3584, 896, 4)])  # llava prefill (G = 4 folded into R)
def test_mvm_kernel_at_the_families_shapes(cuda, b, r, skv, w):
    """Kernel 4 where the encoder-decoder, Griffin and VLM paths launch
    it: W = 8 (head_dim 256), 1500 keys (no multiple of a 16-key group or
    a 128-key tile), one query row, and W = 4; bit-exact, one launch."""
    gen = torch.Generator(device=cuda).manual_seed(r + skv)
    q, k = (torch.randint(-2**31, 2**31 - 1, (b, n, w), generator=gen,
                          device=cuda, dtype=torch.int32) for n in (r, skv))
    before = bmvm.launches
    at_shape = bmvm.shape_launches[(b, r, skv, w)]
    got = bmvm.bacam_mvm(q, k, d=32 * w)
    want = bmvm.bacam_scores_ref(q, k, 32 * w)
    torch.cuda.synchronize()
    assert bmvm.launches == before + 1
    assert bmvm.shape_launches[(b, r, skv, w)] == at_shape + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["whisper-medium", "recurrentgemma-2b"])
def test_families_kernel_route_equals_plain_route_on_card(cuda, monkeypatch,
                                                          arch):
    """The two families at f32 smoke width on ``camformer`` through the
    contiguous steps: ``use_kernel`` against the plain route on the card
    (logits within 1e-5 over prefill + 6 decode steps, fed the same
    tokens).  The kernel route launches kernel 4 for every whole-prompt
    attention (whisper: encoder, decoder and cross-attention at prefill,
    cross-attention at each step) and kernel 3 for whisper's decode
    self-attention; recurrentgemma's ring decode takes the plain CAM
    search (window 8, a 12-token prompt: the ring wraps), so kernel 3
    never runs there.  No kernel's plain version runs on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import get_model_def, init_params, init_pools

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(bmvm, "bacam_scores_ref", plain)
    monkeypatch.setattr(btk, "bacam_topk_stage1_plain", plain)
    kw = dict(n_layers=8, window=8) if arch == "recurrentgemma-2b" else {}
    base = smoke_config(arch, attn_backend="camformer", **kw)
    b, s, steps = 2, 12, 6
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, base.vocab, (b, s), generator=gen)}
    if base.enc_len:
        batch["audio_features"] = torch.randn(
            (b, base.enc_len, base.d_model), generator=gen)
    batch = {k: v.to(cuda) for k, v in batch.items()}
    params = init_params(base, device=cuda, seed=0)
    feed = torch.randint(0, base.vocab, (steps, b), generator=gen).to(cuda)
    out = {}
    for use_kernel in (True, False):
        cfg = base.replace(use_kernel=use_kernel)
        md = get_model_def(cfg)
        caches = init_pools(md.cache_specs(cfg, b, 24), cuda)
        mvm0, topk0 = bmvm.launches, btk.launches
        logits, caches = make_prefill_step(md, cfg)(params, batch, caches)
        serve = make_serve_step(md, cfg)
        rows = [logits]
        pos = torch.full((b,), s, dtype=torch.int32, device=cuda)
        for t in range(steps):
            logits, caches = serve(params, feed[t], pos, pos + 1, caches)
            rows.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        out[use_kernel] = torch.stack(rows)
        if arch == "whisper-medium":
            want = (cfg.enc_layers + cfg.n_layers * (2 + steps),
                    cfg.n_layers * steps)
        else:
            want = (cfg.n_layers // 3, 0)
        got = (bmvm.launches - mvm0, btk.launches - topk0)
        assert got == (want if use_kernel else (0, 0)), (use_kernel, got)
    assert torch.isfinite(out[True]).all()
    torch.testing.assert_close(out[True], out[False], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_distributed_topk_decode_on_one_card(cuda, use_kernel):
    """A B = 1 camformer decode with ``distributed_topk`` in one process
    takes the local CAM search on the card (with ``use_kernel``, one
    launch of kernel 3): equal to the run with the flag off, and within
    1e-5 of the CPU (the integer scores are exact; the softmax and the V
    sum round in another order)."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.backend import get_backend
    from repro_torch.models import init_pools

    cfg = smoke_config("mistral-nemo-12b", attn_backend="camformer",
                       n_heads=4, n_kv_heads=2, use_kernel=use_kernel,
                       distributed_topk=True)
    be = get_backend("camformer")
    length, s, d = 48, 37, cfg.head_dim
    gen = torch.Generator().manual_seed(int(use_kernel))
    k, v = (torch.randn((1, 2, s + 1, d), generator=gen) for _ in range(2))
    q = torch.randn((1, 4, 1, d), generator=gen)

    def decode(c, dev):
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
        cache = init_pools([be.cache_spec(c, 1, length, torch.float32)],
                           dev)[0]
        cache = be.write_cache(cache, k[:, :, :s].to(dev),
                               v[:, :, :s].to(dev), i32(0), c)
        topk0 = btk.launches
        out, _ = be.decode(q.to(dev), cache, k[:, :, s:].to(dev),
                           v[:, :, s:].to(dev), i32(s), i32([s + 1]),
                           i32([[s]]), c)
        torch.cuda.synchronize()
        return out.cpu(), btk.launches - topk0

    got, n = decode(cfg, cuda)
    assert n == (1 if use_kernel else 0)
    assert torch.equal(got, decode(cfg.replace(distributed_topk=False),
                                   cuda)[0])
    torch.testing.assert_close(got, decode(cfg, torch.device("cpu"))[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,kw", [
    ("camformer-bert", dict(attn_backend="camformer", use_kernel=True)),
    ("granite-moe-3b-a800m", dict(n_heads=6, n_kv_heads=2))])
def test_train_step_on_card_equals_cpu(cuda, monkeypatch, arch, kw):
    """Smoke train steps (f32, remat) on the card against the CPU from the
    same parameters and batches: losses within 1e-5 and every gradient
    leaf within 1e-4; with ``use_kernel`` kernel 4 runs twice a layer a
    step (forward and recompute) and its plain version never on the
    card."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_train_step, make_value_and_grad
    from repro_torch.models import cast_params, get_model_def, init_params
    from repro_torch.models.module import tree_leaves

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")

    cfg = smoke_config(arch, **kw)
    md = get_model_def(cfg)
    params = init_params(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=gen)}
    want_l, _, want_g = make_value_and_grad(md, cfg)(params, batch)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    monkeypatch.setattr(bmvm, "bacam_scores_ref", plain)
    before = bmvm.launches
    got_l, _, got_g = make_value_and_grad(md, cfg)(
        cast_params(params, torch.float32, cuda), on_card)
    torch.cuda.synchronize()
    launches = bmvm.launches - before
    assert launches == (2 * cfg.n_layers if cfg.use_kernel else 0)
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    # and two optimizer steps: finite, the loss moves
    step, opt = make_train_step(md, cfg, warmup=1)
    card = cast_params(params, torch.float32, cuda)
    state = {"params": card, "opt": opt.init(card)}
    losses = []
    for _ in range(2):
        state, metrics = step(state, on_card)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[0] != losses[1]


# --- the gateway -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_gateway_sse_equals_in_process_stream_on_card(cuda, backend):
    """A smoke engine on the card behind ``serve_background``: the SSE
    stream of a greedy request and a keyed one equals the same engine
    configuration's in-process ``stream()`` on the card, the runner
    thread survives, and the decode kernels ran once a layer a tick on
    the runner thread."""
    import http.client
    import json

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, SamplingParams, ServeEngine
    from repro_torch.serving.gateway import serve_background

    cfg = smoke_config("camformer-bert", attn_backend=backend)
    params = init_params(cfg, device=cuda, seed=0)
    specs = [dict(prompt=[5, 9, 2, 4, 7, 1], max_new=8),
             dict(prompt=[3, 3, 8], max_new=8, temperature=0.9, top_k=40)]

    def engine():
        return ServeEngine(cfg, params, max_batch=3, max_len=64, page_size=8,
                           mode="overlap", device=cuda)

    ref = engine()
    want = []
    for rid, spec in enumerate(specs):
        sp = {k: v for k, v in spec.items() if k != "prompt"}
        want.append([o.token for o in ref.stream(Request(
            prompt=list(spec["prompt"]), rid=rid,
            sampling=SamplingParams(**sp)))])
    eng = engine()
    before = (bdec.launches, pfd.launches, pfd.prefill_launches)
    handle = serve_background(eng)
    try:
        for rid, spec in enumerate(specs):
            conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                              timeout=120)
            conn.request("POST", "/v1/generate", body=json.dumps(spec))
            resp = conn.getresponse()
            assert resp.status == 200
            events = [json.loads(line[6:]) for line in resp.read().split(
                b"\n") if line.startswith(b"data: ")]
            conn.close()
            assert [e["rid"] for e in events] == [rid] * len(want[rid])
            assert [e["token"] for e in events] == want[rid]
            assert events[-1]["finish_reason"] == "length"
        assert handle.runner.is_alive()
    finally:
        assert handle.stop()
    torch.cuda.synchronize()
    assert eng.tick_errors == 0, eng.last_error
    assert eng.readbacks == eng.ticks + eng.prefill_ticks
    cam, flash, chunks = (now - then for now, then in zip(
        (bdec.launches, pfd.launches, pfd.prefill_launches), before))
    n = cfg.n_layers
    if backend == "camformer":  # CAM decode rows; chunks stay plain
        assert (cam, flash) == (eng.ticks * n, 0)
    else:
        assert (cam, flash - chunks) == (0, eng.ticks * n)
        assert chunks == eng.prefill_ticks * n
    eng.kv.check()


# --- the ssm family and the BA-CAM device model --------------------------------

def test_rwkv6_on_card_equals_cpu(cuda):
    """``rwkv6-3b`` at f32 smoke width (2 layers, two heads of 64): prefill
    of 12 tokens and 8 greedy steps on the card against the CPU, both fed
    the CPU's picks: logits and the carried state (shifts, WKV) within
    1e-4, picks equal; one train step's loss 1e-5 and gradients 1e-4; no
    kernel launched."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_value_and_grad)
    from repro_torch.models import (cast_params, get_model_def, init_params,
                                    init_pools)
    from repro_torch.models.module import tree_leaves

    cfg = smoke_config("rwkv6-3b", d_model=128, remat="full")
    md = get_model_def(cfg)
    params = init_params(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    before = bmvm.launches + btk.launches
    runs = {}
    for dev in ("cpu", cuda):
        p = cast_params(params, torch.float32, dev)
        caches = init_pools(md.cache_specs(cfg, 2, 0), dev)
        lg, caches = make_prefill_step(md, cfg)(p, {"tokens": tokens.to(dev)},
                                                caches)
        rows = [lg.cpu()]
        for step in range(8):
            tok = (rows if dev == "cpu" else runs["cpu"][0])[step].argmax(-1)
            zero = torch.zeros(2, dtype=torch.int32, device=dev)
            lg, caches = make_serve_step(md, cfg)(p, tok.to(dev), zero, zero,
                                                  caches)
            rows.append(lg.cpu())
        runs["cpu" if dev == "cpu" else "cuda"] = (
            rows, {k: v.cpu() for k, v in caches.items()})
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    for name, t in runs["cuda"][1].items():
        torch.testing.assert_close(t, runs["cpu"][1][name], rtol=1e-4,
                                   atol=1e-4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    want_l, _, want_g = make_value_and_grad(md, cfg)(params, batch)
    got_l, _, got_g = make_value_and_grad(md, cfg)(
        cast_params(params, torch.float32, cuda),
        {k: v.to(cuda) for k, v in batch.items()})
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(got_g), tree_leaves(want_g)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert bmvm.launches + btk.launches == before


def test_device_model_on_card_equals_cpu(cuda):
    """The device model's randomness and scores on the card against the
    CPU: threefry bits identical; normals within 4 ulp (``log1p`` is the
    card's or the C library's, each within an ulp or two of the true
    value, the rest identical: tests/test_torch_bacam_device.py); 6-bit
    ADC scores with 1.4% noise equal away from the ADC's rounding
    boundaries; 7-bit scores at d 256 equal to the exact integer path;
    camformer attention with ``rng`` within 1e-4, never reaching the
    kernel even with ``use_kernel``."""
    from repro_torch.core import AttentionSpec, attention
    from repro_torch.core import bacam
    from repro_torch.serving import prng

    key = torch.tensor([0, 42], dtype=torch.int64)
    n = 1 << 20
    assert torch.equal(prng.random_bits(key.to(cuda), n).cpu(),
                       prng.random_bits(key, n))
    a = prng.normal(key, (n,), scale=0.896).numpy()
    b = prng.normal(key.to(cuda), (n,), scale=0.896).cpu().numpy()
    ulp = np.abs(a.view(np.int32).astype(np.int64)
                 - b.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4, ulp.max()
    rng = np.random.default_rng(7)
    pm1 = lambda *s: torch.from_numpy(np.where(  # noqa: E731
        rng.standard_normal(s) > 0, 1.0, -1.0).astype(np.float32))
    qb, kb = pm1(2, 4, 32, 64), pm1(2, 4, 256, 64)
    want = bacam.bacam_scores(qb, kb, exact=False, adc_bits=6,
                              noise_sigma=0.014, rng=key)
    got = bacam.bacam_scores(qb.to(cuda), kb.to(cuda), exact=False,
                             adc_bits=6, noise_sigma=0.014,
                             rng=key.to(cuda)).cpu()
    m = (bacam.binary_scores_exact(qb, kb)[..., None] + 64) * 0.5 + \
        prng.normal(key, (2, 4, 32, 256, 1), scale=0.896)
    t = m.clamp(0, 64).double() * 63 / 64
    near = ((t - t.floor() - 0.5).abs() * 64 / 63 < 1e-5)[..., 0]
    assert torch.equal(got[~near], want[~near])
    qb, kb = pm1(2, 8, 256), pm1(2, 40, 256)
    got = bacam.bacam_scores(qb.to(cuda), kb.to(cuda), exact=False,
                             adc_bits=7)
    assert torch.equal(got.cpu(), bacam.bacam_scores(qb, kb).float())
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 64)).astype(
        np.float32)) for _ in range(3))
    spec = AttentionSpec(mode="camformer", k_top=8, group_size=4,
                         adc_bits=6, noise_sigma=0.014)
    want = attention(q, k, v, spec, rng=key)
    before = bmvm.launches
    got = attention(q.to(cuda), k.to(cuda), v.to(cuda),
                    spec.replace(use_kernel=True), rng=key.to(cuda))
    torch.cuda.synchronize()
    assert bmvm.launches == before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A world-one NCCL group (file rendezvous) and its (1, 1) ``("data",
    "model")`` mesh, installed as the ambient mesh; destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_distributed, make_mesh_for,
                                         set_mesh)

    init_distributed("cuda", init_method=f"file://{tmp_path}/rendezvous",
                     rank=0, world_size=1)
    try:
        mesh = make_mesh_for(1, 1)
        set_mesh(mesh)
        yield mesh
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def test_sharded_step_at_world_one_equals_unsharded(nccl_mesh):
    """The sharded train step (DTensor blocks on the (1, 1) NCCL mesh) of
    camformer-bert smoke with ``use_kernel`` equals the unsharded step on
    the card: 3 steps' losses within 1e-6, kernel 4 launched exactly as
    often (2 a layer a step: forward and recompute)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.train.data import SyntheticLMData

    assert dist.get_backend() == "nccl"
    SHAPES["gpu_dist"] = dict(seq_len=64, global_batch=4, kind="train")
    cfg = smoke_config("camformer-bert", attn_backend="camformer",
                       use_kernel=True)
    md = get_model_def(cfg)
    runs = {}
    for mesh in (None, nccl_mesh):
        data = SyntheticLMData(cfg, "gpu_dist", seed=1, device="cuda",
                               mesh=mesh)
        step, opt = make_train_step(md, cfg, warmup=1, mesh=mesh)
        state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh)
        before, losses = bmvm.launches, []
        for i in range(3):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        runs[mesh is None] = (losses, bmvm.launches - before)
    assert runs[True][1] == runs[False][1] == 2 * cfg.n_layers * 3
    np.testing.assert_allclose(runs[False][0], runs[True][0], rtol=1e-6,
                               atol=0)


def test_distributed_topk_decode_under_a_world_one_group(nccl_mesh):
    """Under the NCCL group and its mesh, a B = 1 camformer decode with
    ``distributed_topk`` (kernel 3 with ``use_kernel``) equals the decode
    with the flag off: no axis of a world of one shards the cache."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.backend import get_backend
    from repro_torch.models import init_pools

    cfg = smoke_config("mistral-nemo-12b", attn_backend="camformer",
                       n_heads=4, n_kv_heads=2, use_kernel=True,
                       distributed_topk=True)
    be = get_backend("camformer")
    length, s, d = 48, 37, cfg.head_dim
    gen = torch.Generator().manual_seed(5)
    k, v = (torch.randn((1, 2, s + 1, d), generator=gen).cuda()
            for _ in range(2))
    q = torch.randn((1, 4, 1, d), generator=gen).cuda()
    i32 = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                 device="cuda")

    def decode(c):
        cache = init_pools([be.cache_spec(c, 1, length, torch.float32)],
                           "cuda")[0]
        cache = be.write_cache(cache, k[:, :, :s], v[:, :, :s], i32(0), c)
        before = btk.launches
        out, _ = be.decode(q, cache, k[:, :, s:], v[:, :, s:], i32(s),
                           i32([s + 1]), i32([[s]]), c)
        torch.cuda.synchronize()
        return out.cpu(), btk.launches - before

    got, n = decode(cfg)
    want, n_off = decode(cfg.replace(distributed_topk=False))
    assert n == n_off == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["camformer", "dense", "binary",
                                     "hybrid"])
def test_tp_rank_shares_equal_tp1_on_the_card(cuda, backend):
    """Tensor-parallel serving's shares at smoke width (f32, 4 kv heads,
    8-token pages) on the card: a 12-token prefill chunk (kernel 2b on
    dense, binary and hybrid) and a decode row a slot (kernel 1 on
    camformer and hybrid, kernel 2 on dense and binary), each run whole
    and as each rank's ``tp_local_decode`` on its head slice of the pool,
    at tp 2 and 4: the rank-order concatenation equals the whole output
    bit for bit, each slice equals the whole pool's (the trash page
    aside), and the ranks launch exactly tp times the whole call's
    kernels."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.backend import get_backend
    from repro_torch.models.attention import tp_local_decode
    from repro_torch.models.transformer import init_pools, lm_page_specs
    from repro_torch.serving import sharded

    cfg = smoke_config("camformer-bert", attn_backend=backend)
    bk = get_backend(backend)
    hkv, h, d = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(3)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32,  # noqa: E731
                                 device="cuda")
    pools = init_pools(lm_page_specs(cfg, 9, 8, 2), "cuda")[0]
    table = i32([[1, 2, 3, 4], [5, 6, 7, 8]])
    base = i32([4, 0])
    steps = [  # (S, positions, kv_len): the chunk, then a decode row
        (12, i32([4, 0])[:, None] + torch.arange(12, dtype=torch.int32,
                                                 device="cuda"),
         i32([16, 0])),
        (1, i32([[16], [0]]), i32([17, 1]))]
    counted = lambda: (bdec.launches, pfd.launches)  # noqa: E731
    for s, positions, kv_len in steps:
        q = torch.randn((2, h, s, d), generator=gen).cuda()
        k, v = (torch.randn((2, hkv, s, d), generator=gen).cuda()
                for _ in range(2))
        before = counted()
        out, whole = bk.paged_decode(q, {n: t.clone() for n, t in
                                         pools.items()}, k, v, positions,
                                     table, kv_len, cfg, base=base)
        torch.cuda.synchronize()
        one = [a - b for a, b in zip(counted(), before)]
        assert sum(one) == (1 if s == 1 or backend != "camformer" else 0)
        for tp in (2, 4):
            before, outs = counted(), []
            for r in range(tp):
                mine = sharded.slice_pools([pools], r, tp)[0]
                o, mine = tp_local_decode(bk, q, mine, k, v, positions,
                                          table, kv_len, cfg, base, r, tp)
                want = sharded.slice_pools([whole], r, tp)[0]
                for n in want:
                    a, b = mine[n], want[n]
                    if n.endswith("_pages"):  # page 0: the trash page
                        a, b = a[1:], b[1:]
                    assert torch.equal(a, b), (s, tp, r, n)
                outs.append(o)
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(counted(), before)] == [
                tp * n for n in one]
            assert torch.equal(torch.cat(outs, dim=1), out), (s, tp)
        pools = whole


def test_model_split_step_at_world_one_equals_unsharded(nccl_mesh):
    """The ``model``-split train step on the (1, 1) NCCL mesh (tp
    profile: the split code on whole blocks, identity collectives) of
    granite smoke (8 padded experts, G = 4) on camformer with
    ``use_kernel`` equals the unsharded step on the card: 3 steps' losses
    within 1e-6, kernel 4 launched exactly as often (2 a layer a step),
    and the split regions ran (every head, every expert, the whole
    vocabulary)."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.sharding import partitioning as P
    from repro_torch.train.data import SyntheticLMData

    SHAPES["gpu_dist"] = dict(seq_len=64, global_batch=4, kind="train")
    cfg = smoke_config("granite-moe-3b-a800m", n_experts_padded=8,
                       attn_backend="camformer", use_kernel=True)
    md = get_model_def(cfg)
    runs = {}
    for mesh in (None, nccl_mesh):
        data = SyntheticLMData(cfg, "gpu_dist", seed=1, device="cuda",
                               mesh=mesh)
        step, opt = make_train_step(md, cfg, warmup=1, mesh=mesh)
        state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh)
        P.SPLIT_SEEN.clear()
        before, losses = bmvm.launches, []
        for i in range(3):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        runs[mesh is None] = (losses, bmvm.launches - before,
                              dict(P.SPLIT_SEEN))
    assert runs[True][2] == {}  # unsharded: no split region
    assert runs[False][2] == dict(attn_q_heads=cfg.n_heads,
                                  attn_kv_heads=cfg.n_kv_heads,
                                  experts=cfg.padded_experts,
                                  vocab_rows=cfg.padded_vocab, res_rows=64)
    assert runs[True][1] == runs[False][1] == 2 * cfg.n_layers * 3
    np.testing.assert_allclose(runs[False][0], runs[True][0], rtol=1e-6,
                               atol=0)


def _share_case(name, backend, use_kernel):
    """(config, block function of (params, *inputs), path of its
    parameters, input shapes) of a split region at smoke width, f32."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import encdec, rglru, rwkv6
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partitioning as P

    b, s = 2, 16
    kw = dict(attn_backend=backend, use_kernel=use_kernel)
    if name == "whisper_decoder_layer":
        cfg = smoke_config("whisper-medium", **kw)

        def fn(p, x, mem):
            return encdec._dec_block(p, x, cfg, mem, None, T.arange_positions(
                b, s, x.device), None, None)[0]

        return cfg, fn, ("dec_blocks", 0), [(b, s, 64), (b, cfg.enc_len, 64)]
    if name == "rglru_block":
        cfg = smoke_config("recurrentgemma-2b", **kw)

        def fn(p, x):
            zero = {n: torch.zeros(shape, dtype=dt, device=x.device)
                    for n, (shape, dt) in rglru._rec_state_spec(cfg, b).items()}
            return rglru._apply_rec(p, x, cfg, zero)[0]

        return cfg, fn, ("rec1", 0), [(b, s, 64)]
    if name == "rwkv_block":
        cfg = smoke_config("rwkv6-3b", rwkv_head_dim=16)

        def fn(p, x):
            z = lambda *shape: torch.zeros(shape, device=x.device)
            return rwkv6._apply_block(p, x, cfg, z(b, 64), z(b, 64),
                                      z(b, 4, 16, 16))[0]

        return cfg, fn, ("blocks", 0), [(b, s, 64)]
    cfg = smoke_config("camformer-bert", **kw)

    def fn(p, x):  # the decoder-only block under res_seq
        pos = T.arange_positions(b, s, x.device)
        seq = P.split_rank() is not None
        y = T._apply_block(p, P.local_seq(x) if seq else x, cfg,
                           positions=pos, cache=None, cache_index=None,
                           kv_len=None, page_table=None, scale_base=None,
                           backend=None, seq=seq)[0]
        return P.whole_seq(y) if seq else y

    return cfg, fn, ("blocks", 0), [(b, s, 64)]


def _share_grads(fn, params, inputs, dev, shares=None):
    """(output, parameter and input gradients) of one forward and backward
    on ``dev``, whole or with ``shares`` = (dims, m) as m shares in
    turn."""
    from repro_torch.launch.steps import share_params
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.sharding import partitioning as P

    live = tree_map(lambda t: t.detach().to(dev).requires_grad_(), params)
    xs = [x.detach().to(dev).requires_grad_() for x in inputs]
    if shares is None:
        out = fn(live, *xs)
    else:
        dims, m = shares
        out = P.run_shares(lambda r: fn(share_params(live, dims, r, m), *xs),
                           m)[0]
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    (out * cot.to(dev)).sum().backward()
    return [out.detach().cpu()] + [t.grad.cpu() for t in tree_leaves(live)
                                   + xs]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", ["whisper_decoder_layer", "rglru_block",
                                  "rwkv_block", "decoder_block_res_seq"])
def test_model_split_shares_on_the_card_match_the_cpu(cuda, name, m):
    """Share mode (each rank's share in turn in one process) on the card
    at smoke width (f32, dense) against the unsplit region on the CPU:
    the output within 1e-5 of max |out|, every parameter's and input's
    gradient within 1e-4."""
    from repro_torch.launch.steps import model_shares
    from repro_torch.models import get_model_def, init_params

    cfg, fn, path, shapes = _share_case(name, "dense", False)
    params = init_params(cfg, device="cpu", seed=0)
    _, dims = model_shares(get_model_def(cfg), cfg, m)
    for k in path:
        params, dims = params[k], dims[k]
    gen = torch.Generator().manual_seed(1)
    inputs = [torch.randn(sh, generator=gen) for sh in shapes]
    want = _share_grads(fn, params, inputs, "cpu")
    got = _share_grads(fn, params, inputs, "cuda", (dims, m))
    assert (got[0] - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    for g, w in zip(got[1:], want[1:]):
        assert (g - w).abs().max() <= 1e-4 * max(1.0, float(w.abs().max()))


def test_model_split_shares_launch_kernel_4_per_rank(cuda):
    """Whisper's decoder layer on camformer with ``use_kernel`` at smoke
    width: its shares on the card at m = 2 launch kernel 4 once for each
    attention of each rank (self and cross: 4; the unsplit layer 2), and
    sum to the unsplit layer on the card (1e-5 of max |out|; gradients
    1e-4)."""
    from repro_torch.launch.steps import model_shares
    from repro_torch.models import get_model_def, init_params

    cfg, fn, path, shapes = _share_case("whisper_decoder_layer", "camformer",
                                        True)
    params = init_params(cfg, device="cpu", seed=0)
    _, dims = model_shares(get_model_def(cfg), cfg, 2)
    for k in path:
        params, dims = params[k], dims[k]
    gen = torch.Generator().manual_seed(1)
    inputs = [torch.randn(sh, generator=gen) for sh in shapes]
    before = bmvm.launches
    want = _share_grads(fn, params, inputs, "cuda")
    torch.cuda.synchronize()
    assert bmvm.launches - before == 2
    got = _share_grads(fn, params, inputs, "cuda", (dims, 2))
    torch.cuda.synchronize()
    assert bmvm.launches - before == 2 + 4
    assert (got[0] - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    for g, w in zip(got[1:], want[1:]):
        assert (g - w).abs().max() <= 1e-4 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("arch", ["whisper-medium", "recurrentgemma-2b",
                                  "rwkv6-3b"])
def test_family_split_step_at_world_one_equals_unsharded(nccl_mesh, arch):
    """The ``model``-split train step of the encoder-decoder, Griffin and
    RWKV-6 families at smoke width on the (1, 1) NCCL mesh (the split
    code on whole blocks, identity collectives; camformer with
    ``use_kernel`` where the family has attention) equals the unsharded
    step on the card bit for bit over 2 steps, kernel 4 launched as
    often, the split regions run."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.steps import init_state, make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.sharding import partitioning as P
    from repro_torch.train.data import SyntheticLMData

    SHAPES["gpu_family"] = dict(seq_len=32, global_batch=2, kind="train")
    cfg = smoke_config(arch, attn_backend="camformer", use_kernel=True)
    md = get_model_def(cfg)
    runs = {}
    for mesh in (None, nccl_mesh):
        data = SyntheticLMData(cfg, "gpu_family", seed=1, device="cuda",
                               mesh=mesh)
        step, opt = make_train_step(md, cfg, warmup=1, mesh=mesh)
        state = init_state(cfg, opt, seed=0, device="cuda", mesh=mesh)
        P.SPLIT_SEEN.clear()
        before, losses = bmvm.launches, []
        for i in range(2):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        runs[mesh is None] = (losses, bmvm.launches - before,
                              dict(P.SPLIT_SEEN))
    assert runs[True][2] == {} and runs[False][2]
    assert runs[True][1] == runs[False][1]
    assert runs[False][0] == runs[True][0]


def _serve_run(md, cfg, params, prompt, steps, cache_len, call):
    """The prefill and ``steps`` greedy steps through ``call(kind, args,
    caches)``: every logits tensor (on the host) and the launches of
    kernels 3 and 4."""
    from repro_torch.launch import steps as S

    b = prompt.shape[0]
    caches = S.init_caches(md, cfg, b, cache_len, device="cuda")
    k3, k4 = btk.launches, bmvm.launches
    out = [call("prefill", ({"tokens": prompt},), caches)]
    for t in range(steps):
        pos = torch.full((b,), prompt.shape[1] + t, dtype=torch.int32,
                         device="cuda")
        tok = out[-1].argmax(-1).to(torch.int32)
        out.append(call("decode", (tok, pos, pos + 1), caches))
    torch.cuda.synchronize()
    return ([o.cpu() for o in out],
            (btk.launches - k3, bmvm.launches - k4))


def test_sharded_serving_steps_at_world_one_equal_the_unsharded(nccl_mesh):
    """``make_prefill_step(mesh=)`` / ``make_serve_step(mesh=)`` on the
    world-one NCCL mesh (1, 1), camformer-bert smoke on camformer with
    ``use_kernel`` (kernel 4 at prefill, kernel 3 each step): every
    logits tensor equal to the unsharded steps' bit for bit, with the
    same launches."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import get_model_def, init_params

    cfg = smoke_config("camformer-bert", attn_backend="camformer",
                       use_kernel=True)
    md = get_model_def(cfg)
    params = init_params(cfg, device="cuda", seed=0)
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).cuda()
    plain = {"prefill": S.make_prefill_step(md, cfg),
             "decode": S.make_serve_step(md, cfg)}
    want, n_want = _serve_run(md, cfg, params, prompt, 4, 32,
                              lambda kind, a, c: plain[kind](
                                  params, *a, c)[0])
    sharded = {"prefill": S.make_prefill_step(md, cfg, mesh=nccl_mesh),
               "decode": S.make_serve_step(md, cfg, mesh=nccl_mesh)}
    blocks = S.serve_params(params, md, cfg, nccl_mesh)
    caches = S.init_caches(md, cfg, 2, 32, nccl_mesh)
    got, n_got = _serve_run(md, cfg, params, prompt, 4, 32,
                            lambda kind, a, _: sharded[kind](
                                blocks, *a, caches)[0].full_tensor())
    assert n_got == n_want == (4 * cfg.n_layers, cfg.n_layers)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("arch, over, m", [
    ("recurrentgemma-2b", dict(n_heads=6), 2),  # qheads, ring split
    ("recurrentgemma-2b", dict(n_heads=6), 4),  # q_seq, ring split
    # 6 heads at 4: attention whole, the cache's sequence split over
    # model; each shard's CAM search takes kernel 3 at shifted positions
    ("camformer-bert", dict(n_heads=6, n_kv_heads=6), 4)])
def test_serving_shares_equal_the_unsplit_steps_on_the_card(cuda, arch,
                                                            over, m):
    """Every rank's share of the sharded serving steps in turn
    (``serve_shares``) on the card, camformer with ``use_kernel`` at
    smoke width: each logits tensor within 1e-5 of max |logits| of the
    unsplit steps', kernel 4 once an attention layer a rank at prefill,
    and (off the ring) kernel 3 once a layer a step a rank."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import get_model_def, init_params

    cfg = smoke_config(arch, attn_backend="camformer", use_kernel=True,
                       **over)
    md = get_model_def(cfg)
    params = init_params(cfg, device="cuda", seed=0)
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(4),
                           dtype=torch.int32).cuda()
    plain = {"prefill": S.make_prefill_step(md, cfg),
             "decode": S.make_serve_step(md, cfg)}
    want, n_want = _serve_run(md, cfg, params, prompt, 4, 32,
                              lambda kind, a, c: plain[kind](
                                  params, *a, c)[0])

    def shares(kind, a, caches):
        outs = S.serve_shares(md, cfg, kind, params, a, caches, m)
        return torch.cat(outs, -1) if outs[0].shape[-1] < \
            cfg.padded_vocab else outs[0]

    got, n_got = _serve_run(md, cfg, params, prompt, 4, 32, shares)
    assert n_got == (n_want[0] * m, n_want[1] * m)
    assert n_got[1] > 0 and (arch == "recurrentgemma-2b" or n_got[0] > 0)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


def test_adamw_update_temporaries_bounded_by_groups(cuda, monkeypatch):
    """One ``adamw`` update of 8 float32 leaves of 256 MiB on the card
    (two groups of ``GROUP_BYTES``): the peak allocated memory rises by at
    most 3 groups' bytes plus 1 MiB (one ``_foreach`` call a stage over
    all leaves would take 3 trees), and params, m and v equal, bit for
    bit, the update run as one group over all leaves on copies of the
    same tensors."""
    from repro_torch.train import optimizer as t_opt

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = lambda s: [torch.randn(64 * 2**20, generator=gen, device=cuda)
                      * s for _ in range(8)]
    opt = t_opt.adamw(t_opt.constant_schedule(1e-3))
    params, grads = tree(1.0), tree(0.1)
    state = {"m": tree(0.01), "v": [x.abs() for x in tree(0.01)],
             "step": torch.zeros((), dtype=torch.int32)}
    want_p = [x.clone() for x in params]
    want_s = dict(state, m=[x.clone() for x in state["m"]],
                  v=[x.clone() for x in state["v"]])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert rise <= 3 * t_opt.GROUP_BYTES + 2**20, rise
    monkeypatch.setattr(t_opt, "GROUP_BYTES", 2**62)
    opt.update(grads, want_s, want_p)
    for got, want in ((params, want_p), (state["m"], want_s["m"]),
                      (state["v"], want_s["v"])):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# the long-context shapes on mistral-nemo-12b's heads (8 kv heads, G = 4,
# head_dim 128): long_500k's 524,288 keys, prefill_32k / decode_32k's
# 2 slots of 32,768
LONG_KEYS, LONG_LEN, LONG_CHUNK = 524288, 32768, 4096


@pytest.mark.parametrize("paged", [True, False])
def test_stage1_kernels_at_half_a_million_keys(cuda, paged):
    """Kernel 1 over one slot's 8,192 pages (a permutation of the pool's)
    and kernel 3 over 8 matrices of G = 4 rows, W = 4, bit-exact against
    their plain versions at the first and the last of 8 decode steps from
    position 524,280 (about 40 distinct scores: ties everywhere)."""
    gen = torch.Generator(device=cuda).manual_seed(29)
    words = lambda *s: torch.randint(-2**31, 2**31 - 1, s, generator=gen,
                                     device=cuda, dtype=torch.int32)
    hkv, g, w = 8, 4, 4
    n_pages = LONG_KEYS // 64
    if paged:
        kp = words(1 + n_pages, hkv, 64, w)
        table = (torch.randperm(n_pages, generator=gen, device=cuda)
                 + 1).to(torch.int32)[None]
        q = words(1, hkv, g, w)
    else:
        kp, q = words(hkv, LONG_KEYS, w), words(hkv, g, w)
    for kv in (LONG_KEYS - 7, LONG_KEYS):
        if paged:
            kv_len = torch.tensor([kv], dtype=torch.int32, device=cuda)
            args = (q, kp, table, kv_len, kv_len - 1)
            got = bdec.bacam_paged_topk_stage1(*args, d=32 * w)
            want = bdec.bacam_paged_topk_ref(*args[:4], 32 * w,
                                             q_pos=args[4])
        else:
            kv_len = torch.full((hkv,), kv, dtype=torch.int32, device=cuda)
            args = (q, kp, (kv_len - 1)[:, None].expand(hkv, g).contiguous(),
                    kv_len)
            got = btk.bacam_topk_stage1(*args, d=32 * w, sq=1)
            want = btk.bacam_topk_stage1_plain(*args, d=32 * w)
        torch.cuda.synchronize()
        _assert_candidates(*got, *want, 16, 2)
        assert got[0].unique().numel() < 64


@pytest.mark.parametrize("sq", [1, LONG_CHUNK])
def test_flash_kernel_at_32k_keys(cuda, sq):
    """Kernel 2 over 2 slots at kv_len 32,768 (split-KV, 512 one-page
    splits) and kernel 2b at the last 4,096-row chunk of two
    32,704-token prompts (q_pos 28,672; chunk tiles), bf16 pools, within
    1e-5 of their plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    b, hkv, g, d, page = 2, 8, 4, 128, 64
    np_ = LONG_LEN // page
    shape = (1 + b * np_, hkv, page, d)
    kp = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    table = (torch.randperm(b * np_, generator=gen, device=cuda)
             + 1).to(torch.int32).reshape(b, np_)
    kv = LONG_LEN if sq == 1 else LONG_LEN - 64
    q_pos = kv - 1 if sq == 1 else (kv // LONG_CHUNK) * LONG_CHUNK
    kv_len = torch.full((b,), kv, dtype=torch.int32, device=cuda)
    qp = torch.full((b,), q_pos, dtype=torch.int32, device=cuda)
    q = torch.randn((b, hkv, g * sq, d), generator=gen, device=cuda) \
        * d**-0.5
    before = pfd.launches
    got = pfd.paged_flash_decode(q, kp, vp, table, kv_len, qp, sq=sq)
    want = pfd.paged_flash_decode_ref(q, kp, vp, table, kv_len, qp, sq=sq)
    torch.cuda.synchronize()
    assert pfd.launches == before + 1
    assert pfd.DESIGNS[pfd.plan(b, hkv, g * sq, d, d, page, np_, sq,
                                True)[0]] == ("split-KV" if sq == 1
                                              else "chunk tiles")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
