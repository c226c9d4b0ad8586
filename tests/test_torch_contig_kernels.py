"""The port's contiguous-path kernels and attention operator, held
against the JAX reference on the CPU.

Each kernel wrapper takes its plain PyTorch version on a CPU tensor; it
is compared with the reference's jnp oracle (``repro.kernels.ref``) and
with the reference's ``ops`` call, whose Pallas kernel runs in interpret
mode, over the shape and flag grids of ``tests/test_kernels.py``.  The
CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions there).

Tolerances: integer scores, candidates and bit-sliced products
bit-exact (top-k indices only where the value is valid: for a fully
masked group the Pallas body writes base+0 twice where ``lax.top_k``
writes base+0, base+1, and both are don't-care); flash attention 1e-5
against the jnp oracle in f32 (the same naive softmax, in another
library) and 2e-5 against the Pallas online softmax, the reference's own
bound; in bf16 both round one f32 result to bf16, so a different f32
summation order can move it by a bf16 step: 2e-2, the reference's own
bf16 bound; ``attention()`` 1e-5 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention import AttentionSpec as JSpec
from repro.core.attention import attention as j_attention
from repro.core.attention import dense_reference as j_dense_reference
from repro.core.attention import make_mask as j_make_mask
from repro.core.bacam import pack_bits as j_pack
from repro.kernels.bacam_mvm import bacam_mvm as j_bacam_mvm
from repro.kernels.bacam_topk import bacam_topk_stage1 as j_bacam_topk
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.core import attention as t_attn
from repro_torch.core.bacam import pack_bits
from repro_torch.kernels import bacam_mvm as t_mvm
from repro_torch.kernels import bacam_topk as t_btk
from repro_torch.kernels import bitslice_vmm as t_bsv
from repro_torch.kernels import flash_attention as t_fla
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

MASKED = j_ref.MASKED_SCORE


def _pm1(rng, shape):
    return np.where(rng.standard_normal(shape) > 0, 1.0,
                    -1.0).astype(np.float32)


def _u32(x):
    return jnp.asarray(np.ascontiguousarray(x).view(np.uint32))


# --- bacam_mvm -------------------------------------------------------------

@pytest.mark.parametrize("b,r,skv,d", [
    (1, 8, 16, 64), (2, 37, 100, 64), (1, 129, 257, 128),
    (3, 8, 40, 256), (1, 300, 64, 96)])
def test_bacam_scores_match_reference(b, r, skv, d):
    rng = np.random.default_rng(r + skv)
    qb, kb = _pm1(rng, (b, r, d)), _pm1(rng, (b, skv, d))
    before = t_mvm.launches
    got = t_ops.bacam_scores(torch.from_numpy(qb), torch.from_numpy(kb))
    assert t_mvm.launches == before  # the CPU path counts no launch
    assert got.dtype == torch.int32
    jq, jk = jnp.asarray(qb), jnp.asarray(kb)
    want = j_ref.bacam_scores_ref(j_pack(jq), j_pack(jk), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ops.bacam_scores(jq, jk)))


def test_bacam_mvm_plain_matches_pallas_on_packed_words():
    """The kernel-level call on packed int32 words (W = 3) against the
    Pallas kernel in interpret mode at its block multiples."""
    rng = np.random.default_rng(3)
    q = rng.integers(-2**31, 2**31, (2, 16, 3)).astype(np.int32)
    k = rng.integers(-2**31, 2**31, (2, 32, 3)).astype(np.int32)
    got = t_mvm.bacam_mvm(torch.from_numpy(q), torch.from_numpy(k), d=96)
    want = j_bacam_mvm(_u32(q), _u32(k), d=96, block_q=8, block_k=16,
                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- bacam_topk_stage1 -----------------------------------------------------

def _topk_inputs(seed, b=2, r=24, skv=96, d=64):
    rng = np.random.default_rng(seed)
    qb, kb = _pm1(rng, (b, r, d)), _pm1(rng, (b, skv, d))
    qpos = np.tile(np.arange(r, dtype=np.int32)[None] * 4, (b, 1))
    kvlen = np.array([skv, skv - 30], np.int32)[:b]
    return qb, kb, qpos, kvlen


def _assert_candidates(tv, ti, jv, ji):
    np.testing.assert_array_equal(tv, jv)
    valid = jv > -1e8 if jv.dtype == np.float32 else jv > MASKED // 2
    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal(ti[valid], ji[valid])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
@pytest.mark.parametrize("group,s1", [(16, 2), (8, 1), (4, 4)])
def test_bacam_topk_stage1_matches_reference(causal, window, group, s1):
    qb, kb, qpos, kvlen = _topk_inputs(group * 10 + s1 + int(causal))
    kw = dict(group=group, stage1_k=s1, causal=causal, window=window)
    tv, ti = t_ops.bacam_attention_scores_topk(
        *[torch.from_numpy(x) for x in (qb, kb, qpos, kvlen)], **kw)
    jv, ji = j_ops.bacam_attention_scores_topk(
        *[jnp.asarray(x) for x in (qb, kb, qpos, kvlen)], **kw)
    _assert_candidates(tv.numpy(), ti.numpy(), np.asarray(jv),
                       np.asarray(ji))
    # the kernel-level plain version against the jnp oracle
    qp, kp = pack_bits(torch.from_numpy(qb)), pack_bits(torch.from_numpy(kb))
    before = t_btk.launches
    rv, ri = t_btk.bacam_topk_stage1(
        qp, kp, torch.from_numpy(qpos), torch.from_numpy(kvlen)[:, None],
        d=qb.shape[-1], **kw)
    assert t_btk.launches == before
    ov, oi = j_ref.bacam_topk_stage1_ref(
        j_pack(jnp.asarray(qb)), j_pack(jnp.asarray(kb)), qb.shape[-1],
        jnp.asarray(qpos), group_size=group, stage1_k=s1, causal=causal,
        window=window, kv_len=jnp.asarray(kvlen))
    _assert_candidates(rv.numpy(), ri.numpy(), np.asarray(ov),
                       np.asarray(oi))


@pytest.mark.parametrize("skv,rows", [(100, 5), (1, 3), (37, 1)])
def test_bacam_topk_ragged_keys_match_reference(skv, rows):
    """Skv not a multiple of the group: ceil(Skv / group) groups, the
    last one masked past Skv, indices clamped to Skv - 1 (the reference
    pads to its block instead)."""
    rng = np.random.default_rng(skv)
    b, d = 3, 128
    qb, kb = _pm1(rng, (b, rows, d)), _pm1(rng, (b, skv, d))
    qpos = np.tile(np.arange(rows, dtype=np.int32)[None] + skv - rows,
                   (b, 1)).clip(0)
    kvlen = np.array([skv, max(skv - 7, 0), (skv + 1) // 2], np.int32)
    tv, ti = t_ops.bacam_attention_scores_topk(
        *[torch.from_numpy(x) for x in (qb, kb, qpos, kvlen)], group=16,
        stage1_k=2)
    jv, ji = j_ops.bacam_attention_scores_topk(
        *[jnp.asarray(x) for x in (qb, kb, qpos, kvlen)], group=16,
        stage1_k=2)
    assert tv.shape == (b, rows, 2 * -(-skv // 16))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    valid = np.asarray(jv) > -1e8
    np.testing.assert_array_equal(ti.numpy()[valid], np.asarray(ji)[valid])
    assert int(ti.max()) <= skv - 1


@pytest.mark.parametrize("case", ["ties", "masked groups"])
def test_bacam_topk_stage1_ties_and_masked_groups(case):
    """All-tie groups (every key of a group carries one key word) and
    fully masked groups (a causal chunk at positions 0..15 over 64 keys at
    kv_len 16, and an inert row set at kv_len 0): the plain version against
    the jnp oracle on values and every index, fully masked groups at
    base + s, and against the Pallas kernel in interpret mode on values and
    valid indices (the Pallas body writes base + 0 for every candidate of a
    fully masked group, ROADMAP faults)."""
    rng = np.random.default_rng(len(case))
    b, r, skv, w, group, s1 = 2, 16, 64, 2, 16, 2
    q = rng.integers(-2**31, 2**31, (b, r, w)).astype(np.int32)
    k = rng.integers(-2**31, 2**31, (b, skv, w)).astype(np.int32)
    if case == "ties":
        k = np.repeat(k[:, ::group], group, axis=1)
        kvlen = np.array([skv, skv - 20], np.int32)
        qpos = np.tile(np.arange(r, dtype=np.int32) * 4, (b, 1))
    else:
        kvlen = np.array([r, 0], np.int32)
        qpos = np.tile(np.arange(r, dtype=np.int32), (b, 1))
    tv, ti = t_btk.bacam_topk_stage1(
        *(torch.from_numpy(x) for x in (q, k, qpos, kvlen)), d=32 * w,
        group=group, stage1_k=s1)
    tv, ti = tv.numpy(), ti.numpy()
    jargs = (_u32(q), _u32(k), jnp.asarray(qpos))
    ov, oi = j_ref.bacam_topk_stage1_ref(
        *jargs[:2], 32 * w, jargs[2], group_size=group, stage1_k=s1,
        kv_len=jnp.asarray(kvlen))
    np.testing.assert_array_equal(tv, np.asarray(ov))
    np.testing.assert_array_equal(ti, np.asarray(oi))
    dead = tv.reshape(b, r, -1, s1)[..., 0] == MASKED
    base = (np.arange(skv // group)[:, None] * group + np.arange(s1))
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(ti.reshape(b, r, -1, s1)[dead],
                                  np.broadcast_to(base, dead.shape + (s1,))[
                                      dead])
    pv, pi = j_bacam_topk(*jargs, jnp.asarray(kvlen)[:, None], d=32 * w,
                          group=group, stage1_k=s1, block_q=r, block_k=skv,
                          interpret=True)
    _assert_candidates(tv, ti, np.asarray(pv), np.asarray(pi))


# --- flash_attention -------------------------------------------------------

FLASH_CASES = [(2, 64, 64, 64, True, 0, None), (1, 128, 128, 32, True, 0, 48),
               (2, 16, 128, 64, True, 112, None),
               (1, 64, 128, 64, False, 0, None),
               # ragged Sq and Skv, D = 96 and 128 (the widths the card's
               # tests run; causal where Skv is not a key-block multiple)
               (2, 50, 77, 96, True, 27, None), (1, 40, 64, 128, False, 0, 20),
               (1, 33, 45, 128, True, 12, 9)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,d,causal,off,win", FLASH_CASES)
def test_flash_attention_matches_reference(dtype, b, sq, skv, d, causal, off,
                                           win):
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32)
               for n in (sq, skv, skv))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    before = t_fla.launches
    got = t_ops.flash_attention(tq, tk, tv, off, causal=causal, window=win,
                                block_k=32)
    assert t_fla.launches == before
    assert got.dtype == tdt and got.shape == (b, sq, d)
    got = got.to(torch.float32).numpy()
    oracle = j_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       q_offset=off, window=win)
    pallas = j_ops.flash_attention(jq, jk, jv, off, causal=causal,
                                   window=win, block_q=32, block_k=32)
    tol_oracle, tol_pallas = (1e-5, 2e-5) if dtype == "float32" else (2e-2,
                                                                       2e-2)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               rtol=tol_oracle, atol=tol_oracle)
    assert np.abs(got - np.asarray(pallas, np.float32)).max() < tol_pallas


def test_flash_attention_masks_keys_past_skv():
    """Causal rows past Skv (q_offset + Sq > Skv): the port masks every
    key at or past Skv and so matches the jnp oracle; the reference's
    Pallas path pads K with zeros to its key block, and rows at
    positions >= Skv see those padded keys (ROADMAP, faults section)."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, n, 32)).astype(np.float32)
               for n in (8, 20, 20))
    off = 16  # rows 4..7 sit at positions 20..23, past Skv = 20
    got = t_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                off, causal=True, block_k=16).numpy()
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    oracle = np.asarray(j_ref.flash_attention_ref(*jargs, causal=True,
                                                  q_offset=off))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(j_ops.flash_attention(*jargs, off, causal=True,
                                              block_q=8, block_k=16))
    np.testing.assert_allclose(got[:, :4], pallas[:, :4], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(got[:, 4:] - pallas[:, 4:]).max() > 1e-3


def test_flash_attention_refuses_what_the_reference_cannot_pad():
    """A non-causal call whose Skv is not a block multiple raises in both
    packages; under causal masking both accept it."""
    q = np.zeros((1, 8, 32), np.float32)
    k = np.zeros((1, 20, 32), np.float32)
    with pytest.raises(ValueError):
        j_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, k)),
                              causal=False, block_k=16)
    with pytest.raises(ValueError):
        t_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, k)),
                              causal=False, block_k=16)
    t_ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, k)),
                          causal=True, block_k=16)


# --- bitslice_vmm ----------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8, 12, 16])
@pytest.mark.parametrize("b,r,n,d", [(1, 8, 16, 64), (2, 17, 33, 64),
                                     (1, 64, 40, 128)])
def test_bitslice_vmm_matches_reference(bits, b, r, n, d):
    """Including w at both ends of its range against an all +1 row (the
    largest sums of the case)."""
    rng = np.random.default_rng(bits * 100 + r)
    x = _pm1(rng, (b, r, d))
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    w = rng.integers(lo, hi, (b, n, d)).astype(np.int32)
    x[:, 0] = 1.0
    w[:, 0] = lo
    w[:, -1] = hi - 1
    got = t_ops.bitslice_vmm(torch.from_numpy(x), torch.from_numpy(w),
                             bits=bits)
    assert got.dtype == torch.int32
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_ref.bitslice_vmm_ref(jx, jw, bits)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        j_ops.bitslice_vmm(jx, jw, bits=bits)))
    # the per-plane loop the card runs, here through the plain mvm
    loop = t_bsv.plane_loop(torch.from_numpy(x), torch.from_numpy(w),
                            bits=bits)
    np.testing.assert_array_equal(loop.numpy(), got.numpy())
    planes = t_ref.int_slices(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(j_ref.int_slices(jw, bits)).astype(
            np.int32))


# --- attention() in its three modes ---------------------------------------

@pytest.mark.parametrize("mode", ["dense", "binary", "camformer"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("h,hkv,window", [(8, 4, None), (4, 4, 5)])
def test_attention_matches_reference(mode, use_kernel, h, hkv, window):
    """GQA group axis, causal masking at per-row positions with an
    optional window, selection on the raw scores; f32, 1e-5."""
    rng = np.random.default_rng(h + hkv)
    b, sq, d = 2, 16, 64
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sq, d)).astype(np.float32)
    pos = np.tile(np.arange(sq, dtype=np.int32)[None], (b, 1))
    kw = dict(k_top=8, group_size=4, stage1_k=2, use_kernel=use_kernel)
    got = t_attn.attention(
        *(torch.from_numpy(x) for x in (q, k, v)),
        t_attn.AttentionSpec(mode=mode, **kw),
        q_positions=torch.from_numpy(pos), window=window)
    want = j_attention(*(jnp.asarray(x) for x in (q, k, v)),
                       JSpec(mode=mode, **kw), q_positions=jnp.asarray(pos),
                       window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_attention_masks_and_reference_helpers():
    rng = np.random.default_rng(5)
    b, sq, skv = 2, 4, 9
    qpos = rng.integers(0, skv, (b, sq)).astype(np.int32)
    kvpos = np.tile(np.arange(skv, dtype=np.int32)[None], (b, 1))
    valid = rng.random((b, skv)) > 0.3
    got = t_attn.make_mask(sq, skv, q_positions=torch.from_numpy(qpos),
                           kv_positions=torch.from_numpy(kvpos),
                           kv_valid=torch.from_numpy(valid), window=3)
    want = j_make_mask(sq, skv, q_positions=jnp.asarray(qpos),
                       kv_positions=jnp.asarray(kvpos),
                       kv_valid=jnp.asarray(valid), window=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, k, v = (rng.standard_normal((b, 2, skv, 32)).astype(np.float32)
               for _ in range(3))
    got = t_attn.dense_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=False)
    want = j_dense_reference(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_unported_options_raise():
    q = torch.zeros((1, 2, 4, 32))
    for spec in (t_attn.AttentionSpec(mode="camformer", adc_bits=6),
                 t_attn.AttentionSpec(mode="binary", noise_sigma=0.01)):
        with pytest.raises(NotImplementedError):
            t_attn.attention(q, q, q, spec)
    # trainable binarization is ported (core/binarize.sign_ste): same
    # forward as the hard sign
    q = torch.randn((1, 2, 4, 32), generator=torch.Generator().manual_seed(0))
    spec = t_attn.AttentionSpec(mode="camformer", k_top=2, group_size=2)
    assert torch.equal(
        t_attn.attention(q, q, q, spec.replace(trainable_binarize=True)),
        t_attn.attention(q, q, q, spec))
