"""Dispatch wrappers for the CUDA kernels.

These present the kernels with framework-friendly shapes (sign packing,
query pre-scaling, GQA row folding, NEG_INF conversion of masked
candidates), as the reference package's ``kernels/ops.py`` does.
Dispatch follows the tensors' device: the kernel wrappers launch the
CUDA kernel for a CUDA tensor and take the plain PyTorch version for a
CPU tensor.  The reference pads operands to its TPU block sizes; the
CUDA kernels mask their own ragged edges, so nothing here pads.
"""

from __future__ import annotations

import torch

from repro_torch.core.bacam import pack_bits
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels import bacam_decode as _bdec
from repro_torch.kernels import bacam_mvm as _mvm
from repro_torch.kernels import bacam_topk as _btk
from repro_torch.kernels import bitslice_vmm as _bsv
from repro_torch.kernels import flash_attention as _fla
from repro_torch.kernels import paged_flash_decode as _pfd
from repro_torch.kernels.ref import MASKED_SCORE

__all__ = ["bacam_scores", "bacam_attention_scores_topk",
           "bacam_attention_scores_topk_packed", "bacam_paged_scores_topk",
           "flash_attention", "paged_flash_decode", "paged_flash_prefill",
           "bitslice_vmm", "MASKED_SCORE"]


def _i32(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape(b).to(torch.int32).contiguous()


def _masked_to_neg_inf(vals: torch.Tensor) -> torch.Tensor:
    """int32 candidate scores -> float32 with NEG_INF where masked."""
    return torch.where(vals <= MASKED_SCORE // 2,
                       torch.full_like(vals, NEG_INF, dtype=torch.float32),
                       vals.to(torch.float32))


def bacam_scores(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Binary scores through the BA-CAM kernel (kernels/bacam_mvm.py).

    qb: (B*, R, D) ±1; kb: (B*, Skv, D) ±1 (3-D: callers fold GQA and
    batch).  Returns (B*, R, Skv) int32.
    """
    d = qb.shape[-1]
    return _mvm.bacam_mvm(pack_bits(qb).contiguous(),
                          pack_bits(kb).contiguous(), d=d)


def bacam_attention_scores_topk(qb, kb, q_pos, kv_len, *, group: int = 16,
                                stage1_k: int = 2, causal: bool = True,
                                window: int | None = None):
    """Fused association stage on ±1 operands: binary scores + stage-1
    top-k candidates (see ``bacam_attention_scores_topk_packed``).

    qb: (B, R, D) ±1; kb: (B, Skv, D) ±1; q_pos: (B, R); kv_len: (B,)
    or (B, 1).
    """
    return bacam_attention_scores_topk_packed(
        pack_bits(qb), pack_bits(kb), q_pos, kv_len, d=qb.shape[-1],
        group=group, stage1_k=stage1_k, causal=causal, window=window)


def bacam_attention_scores_topk_packed(qp, kp, q_pos, kv_len, *, d: int,
                                       group: int = 16, stage1_k: int = 2,
                                       causal: bool = True,
                                       window: int | None = None,
                                       sq: int | None = None):
    """The association stage on packed operands (the camformer cache
    stores keys packed), through kernels/bacam_topk.py.

    qp: (B, R, W) int32; kp: (B, Skv, W) int32; q_pos: (B, R); kv_len:
    (B,) or (B, 1); sq: the query positions among the R rows (R = G * sq
    with GQA rows folded; the kernel wrapper's launch counts read it).
    Returns (cand_vals float32 with NEG_INF at masked candidates,
    cand_idx int32 clamped to Skv - 1), both
    (B, R, stage1_k * ceil(Skv / group)).
    """
    b = qp.shape[0]
    skv = kp.shape[1]
    vals, idx = _btk.bacam_topk_stage1(
        qp.contiguous(), kp.contiguous(),
        q_pos.to(torch.int32).contiguous(), _i32(kv_len, b), d=d,
        group=group, stage1_k=stage1_k, causal=causal, window=window, sq=sq)
    return _masked_to_neg_inf(vals), torch.clamp(idx, max=skv - 1)


def bacam_paged_scores_topk(qp, kp_pages, page_table, kv_len, q_pos=None, *,
                            d: int, group: int = 16, stage1_k: int = 2,
                            window: int | None = None):
    """Fused paged decode association stage (see kernels/bacam_decode.py).

    qp: (B, H_kv, R, W) int32 decode rows; kp_pages: (P, H_kv, page, W)
    int32 pool; page_table: (B, NP); kv_len, q_pos: (B,) (q_pos defaults
    to kv_len - 1, the decode tail).  Returns (cand_vals float32 with
    NEG_INF at masked candidates, cand_idx int32 logical key indices
    clipped into the table extent), shapes
    (B, H_kv, R, stage1_k * NP * page / group).
    """
    b = qp.shape[0]
    page = kp_pages.shape[2]
    np_ = page_table.shape[1]
    if q_pos is None:
        q_pos = kv_len.reshape(-1) - 1
    vals, idx = _bdec.bacam_paged_topk_stage1(
        qp.contiguous(), kp_pages, page_table.to(torch.int32).contiguous(),
        _i32(kv_len, b), _i32(q_pos, b), d=d, group=group,
        stage1_k=stage1_k, window=window)
    return _masked_to_neg_inf(vals), idx.clamp(0, np_ * page - 1)


def paged_flash_prefill(q, k_pages, v_pages, page_table, kv_len, q_pos, *,
                        temp=None, scale=None, binary=False, window=None):
    """Paged flash attention for chunk rows (chunked prefill; Sq >= 1).

    q: (B, H, Sq, D); kv_len: (B,) post-write extent INCLUDING the chunk;
    q_pos: (B,) the chunk's FIRST position per slot (row s anchors at
    q_pos + s).  temp: (B, H_kv, G * Sq) per-row temperature.  The chunk
    folds into the row axis as row r = g * sq + s.  Returns
    (B, H, Sq, Dv) in q's dtype; kv_len == 0 rows are zeros.
    """
    b, h, sq, d = q.shape
    hkv = k_pages.shape[1]
    g = h // hkv
    dv = v_pages.shape[-1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qr = q.reshape(b, hkv, g, sq, d).to(torch.float32)
    if binary:
        qr = torch.where(qr > 0, 1.0, -1.0)
    # the temperature is per query row: fold it (and the score scale)
    # into the query operand so the stream needs no post-hoc rescale
    qr = qr * torch.tensor(scale, dtype=torch.float32)
    if temp is not None:
        qr = qr * temp.reshape(b, hkv, g, sq, 1).to(torch.float32)
    qr = qr.reshape(b, hkv, g * sq, d)  # row r = g_idx * sq + s
    out = _pfd.paged_flash_decode(
        qr.contiguous(), k_pages, v_pages,
        page_table.to(torch.int32).contiguous(), _i32(kv_len, b),
        _i32(q_pos, b), sq=sq, binary=binary, window=window)
    return out.reshape(b, h, sq, dv).to(q.dtype)


def paged_flash_decode(q, k_pages, v_pages, page_table, kv_len, q_pos, *,
                       temp=None, scale=None, binary=False, window=None):
    """Paged flash decode for Sq == 1 rows: ``paged_flash_prefill`` with
    one row per query head.  q: (B, H, 1, D); temp: (B, H_kv, G).
    Returns (B, H, 1, Dv) in q's dtype; kv_len == 0 rows are zeros."""
    if q.shape[2] != 1:
        raise ValueError("paged_flash_decode is the decode (Sq == 1) path")
    return paged_flash_prefill(q, k_pages, v_pages, page_table, kv_len,
                               q_pos, temp=temp, scale=scale, binary=binary,
                               window=window)


def flash_attention(q, k, v, q_offset=0, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    block_k: int = 512):
    """Dense flash attention (kernels/flash_attention.py); q: (B*, Sq, D),
    k/v: (B*, Skv, D).  Returns (B*, Sq, D) in q's dtype.

    ``block_k`` only decides which inputs are accepted: the reference
    pads Skv to its key block, which it can mask only under causal
    masking, so a non-causal call whose Skv is not a multiple of
    ``min(block_k, ceil8(Skv))`` raises here as it does there.
    """
    skv = k.shape[1]
    bk = min(block_k, -(-max(skv, 1) // 8) * 8)
    if skv % bk and not causal:
        raise ValueError("non-causal flash requires Skv % block_k == 0")
    return _fla.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), q_offset, causal=causal,
                                window=window, scale=scale)


def bitslice_vmm(x_pm1, w_int, *, bits: int):
    """Exact int VMM by bit slicing (kernels/bitslice_vmm.py); x: (B, R, d)
    ±1, w_int: (B, N, d).  Returns (B, R, N) int32."""
    return _bsv.bitslice_vmm(x_pm1, w_int, bits=bits)
