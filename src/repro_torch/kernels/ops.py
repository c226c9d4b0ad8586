"""Dispatch wrappers for the paged decode kernels.

These present the kernels with framework-friendly shapes (query
pre-scaling, GQA row folding, NEG_INF conversion of masked candidates),
as the reference package's ``kernels/ops.py`` does.  Dispatch follows
the tensors' device: the kernel wrappers launch the CUDA kernel for a
CUDA tensor and take the plain PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import NEG_INF
from repro_torch.kernels import bacam_decode as _bdec
from repro_torch.kernels import paged_flash_decode as _pfd
from repro_torch.kernels.ref import MASKED_SCORE

__all__ = ["bacam_paged_scores_topk", "paged_flash_decode",
           "paged_flash_prefill", "MASKED_SCORE"]


def _i32(x: torch.Tensor, b: int) -> torch.Tensor:
    return x.reshape(b).to(torch.int32).contiguous()


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
    fvals = torch.where(vals <= MASKED_SCORE // 2,
                        torch.full_like(vals, NEG_INF, dtype=torch.float32),
                        vals.to(torch.float32))
    return fvals, idx.clamp(0, np_ * page - 1)


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
