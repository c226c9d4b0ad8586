"""CAMformer attention against paged pools (Eq. 1 of the paper).

    CAMformer-Attn(Q, K, V) = SoftMax(Top-32(QK^T)) . V

with QK^T computed on binarized operands (BA-CAM scores) and Top-32 the
two-stage hierarchical top-k.  Selection is on the RAW binary score; the
HAD scales enter only as a softmax temperature over the survivors.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bacam
from repro_torch.core.binarize import had_scales, sign_pm1
from repro_torch.core.topk import NEG_INF, stable_topk, two_stage_topk

__all__ = ["AttentionSpec", "dense_attention", "camformer_paged_attention",
           "topk_softmax_weights"]

# Bound on the XOR temporary of the gather branch, in int32 words: long
# prompt chunks are scored a slice of rows at a time.
_GATHER_WORDS = 1 << 25


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Two-stage top-k configuration of the CAMformer operator."""

    k_top: int = 32
    group_size: int = 16  # CAM_H
    stage1_k: int = 2


def topk_softmax_weights(top_v, temp, scale):
    """Softmax over top-k survivors (the hardware's LUT stage).

    top_v: (..., k) raw binary scores with NEG_INF at masked entries;
    temp broadcastable to top_v; scale: 1/sqrt(d).  Returns (weights,
    valid), weights exactly 0 at invalid entries.
    """
    valid = top_v > NEG_INF / 2
    neg = torch.full_like(top_v, NEG_INF)
    logits = torch.where(valid, top_v * temp * scale, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.where(valid, w, torch.zeros_like(w)), valid


def dense_attention(q, k, v, mask):
    """Masked softmax attention with GQA folding, scale 1/sqrt(D).

    q: (B, H, Sq, D); k/v: (B, H_kv, Skv, D); mask broadcastable to
    (B, 1, 1, Sq, Skv).  Returns (B, H, Sq, Dv) in q's dtype.
    """
    b, h, sq, d = q.shape
    hkv, dv = v.shape[1], v.shape[-1]
    scale = 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return out.reshape(b, h, sq, dv).to(q.dtype)


def _gather_topk(qp, kp, kv_len, q_positions, spec, d, g, window):
    """The Sq > 1 branch: score packed rows against the gathered packed
    keys and run the two-stage top-k, a slice of rows at a time so the
    (rows, S_log, W) XOR temporary stays bounded."""
    b, hkv, rows, w = qp.shape
    s_log = kp.shape[2]
    sq = rows // g
    kpos = torch.arange(s_log, dtype=torch.int32, device=qp.device)
    qpos = q_positions.to(torch.int32)[:, None, None, :].expand(
        b, hkv, g, sq).reshape(b, hkv, rows, 1)
    step = max(1, _GATHER_WORDS // max(1, b * hkv * s_log * w))
    top_v, top_i = [], []
    for r0 in range(0, rows, step):
        scores = bacam.hamming_scores_packed(qp[:, :, r0:r0 + step], kp, d)
        qr = qpos[:, :, r0:r0 + step]
        ok = (kpos < kv_len.reshape(b, 1, 1, 1)) & (kpos <= qr)
        if window is not None:
            ok = ok & (kpos > qr - window)
        v, i = two_stage_topk(scores, k=spec.k_top,
                              group_size=spec.group_size,
                              stage1_k=spec.stage1_k, where=ok)
        top_v.append(v)
        top_i.append(i)
    return torch.cat(top_v, dim=2), torch.cat(top_i, dim=2)


def camformer_paged_attention(q, kp_pages, v_pages, k_scale, page_table,
                              kv_len, q_positions,
                              spec: AttentionSpec = AttentionSpec(), *,
                              window=None, scale=None, impl="fused"):
    """CAMformer attention against a paged, bit-packed KV cache.

    Decode rows (Sq == 1) with ``impl="fused"`` go through the paged CAM
    kernel (kernels/bacam_decode.py) for scoring + stage-1 top-k, then a
    stable stage-2 top-k.  Prefill chunks (Sq > 1) and ``impl="gather"``
    gather the packed keys into logical order and run the same two-stage
    selection in plain PyTorch.  Softmax runs over the k survivors and
    only the selected V rows are gathered from the paged pool.

    q: (B, H, Sq, D); kp_pages: (P, H_kv, page, D/32) int32; v_pages:
    (P, H_kv, page, Dv); k_scale: (B, H_kv) running key scale;
    page_table: (B, NP); kv_len: (B,); q_positions: (B, Sq).
    Returns (B, H, Sq, Dv) in q's dtype.
    """
    b, h, sq, d = q.shape
    _, hkv, page, dv = v_pages.shape
    g = h // hkv
    np_ = page_table.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qf = q.to(torch.float32)
    q_scale = had_scales(qf, keepdim=False)  # (B, H, Sq)
    qp = bacam.pack_bits(sign_pm1(qf)).reshape(b, hkv, g * sq, d // 32)
    kv_len = kv_len.reshape(b).to(torch.int32)

    if sq == 1 and impl == "fused":
        from repro_torch.kernels import ops as kops  # local: no cycle

        cand_v, cand_i = kops.bacam_paged_scores_topk(
            qp, kp_pages, page_table, kv_len, q_positions.reshape(b),
            d=d, group=spec.group_size, stage1_k=spec.stage1_k,
            window=window)
        top_v, sel = stable_topk(cand_v, min(spec.k_top, cand_v.shape[-1]))
        top_i = torch.gather(cand_i, -1, sel)
    else:
        from repro_torch.kernels.ref import paged_gather_ref

        kp = paged_gather_ref(kp_pages, page_table)  # (B, H_kv, S_log, W)
        top_v, top_i = _gather_topk(qp, kp, kv_len, q_positions, spec, d, g,
                                    window)

    # sparse V contextualization straight from the paged pool
    top_i = top_i.long()
    pg = top_i // page  # logical page of each selected key (in range)
    row = top_i % page
    pt = page_table.long().clamp(0, v_pages.shape[0] - 1)
    phys = torch.gather(pt[:, None, None, :].expand(b, hkv, g * sq, np_), -1,
                        pg)  # (B, H_kv, R, K)
    heads = torch.arange(hkv, device=q.device)[None, :, None, None]
    v_sel = v_pages[phys, heads, row]  # (B, H_kv, R, K, Dv)

    ks = k_scale.to(torch.float32)[:, :, None, None]  # (B, H_kv, 1, 1)
    temp = q_scale.reshape(b, hkv, g * sq)[..., None] * ks
    w, _ = topk_softmax_weights(top_v, temp, scale)
    out = torch.einsum("bhrk,bhrkd->bhrd", w.to(v_pages.dtype), v_sel)
    return out.reshape(b, h, sq, dv).to(q.dtype)
