"""Plain PyTorch versions of the CUDA kernels.

Each function is the semantics its CUDA kernel is held against (on the
card, by ``chip_smoke.py``) and the path every kernel wrapper takes for a
tensor that lies on the CPU.  They follow the reference package's
``kernels/ref.py`` function by function: same shapes, same masking, the
same page order and accumulation order for the flash walk.  Packed words
are int32 tensors carrying the reference's uint32 bits.
"""

from __future__ import annotations

import torch

from repro_torch.core.bacam import hamming_scores_packed
from repro_torch.core.topk import NEG_INF, stable_topk

__all__ = ["MASKED_SCORE", "bacam_scores_ref", "masked_scores_ref",
           "bacam_topk_stage1_ref", "paged_gather_ref",
           "paged_flash_decode_ref", "bacam_paged_topk_ref",
           "flash_attention_ref", "bitslice_vmm_ref", "int_slices"]

MASKED_SCORE = -(2**30)  # integer "minus infinity" for masked binary scores


def bacam_scores_ref(q_packed: torch.Tensor, k_packed: torch.Tensor,
                     d: int) -> torch.Tensor:
    """Binary QK^T from packed operands: ``d - 2 * popcount(q ^ k)``.

    q_packed: (B, R, W) int32; k_packed: (B, Skv, W) int32.  Returns
    (B, R, Skv) int32.
    """
    return hamming_scores_packed(q_packed, k_packed, d)


def masked_scores_ref(scores, q_pos, *, causal: bool, window: int | None,
                      kv_len) -> torch.Tensor:
    """Causal / window / valid-length masking with the integer sentinel.

    scores: (B, R, Skv); q_pos: (B, R); kv_len: (B,), (B, 1) or an int.
    """
    skv = scores.shape[-1]
    kpos = torch.arange(skv, dtype=torch.int32, device=scores.device)
    qpos = q_pos[:, :, None]
    kvl = torch.as_tensor(kv_len, dtype=torch.int32, device=scores.device)
    ok = kpos < kvl.reshape(-1, 1, 1)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, scores, torch.full_like(scores, MASKED_SCORE))


def bacam_topk_stage1_ref(q_packed, k_packed, d: int, q_pos, *,
                          group_size: int = 16, stage1_k: int = 2,
                          causal: bool = True, window: int | None = None,
                          kv_len=None):
    """Scores + stage-1 top-k over a contiguous packed key cache.

    q_packed: (B, R, W) int32; k_packed: (B, Skv, W) int32 with Skv a
    multiple of ``group_size``; q_pos: (B, R); kv_len: (B,) / (B, 1) /
    int (default Skv).  Returns (cand_vals, cand_idx), both (B, R,
    stage1_k * Skv / group) int32: per group of keys, in group order, the
    top ``stage1_k`` masked scores (MASKED_SCORE when masked) and their
    global key indices, ties to the lowest index.
    """
    b, r, _ = q_packed.shape
    skv = k_packed.shape[1]
    if kv_len is None:
        kv_len = skv
    s = bacam_scores_ref(q_packed, k_packed, d)
    s = masked_scores_ref(s, q_pos, causal=causal, window=window,
                          kv_len=kv_len)
    groups = skv // group_size
    v, i = stable_topk(s.reshape(b, r, groups, group_size), stage1_k)
    gi = i + (torch.arange(groups, dtype=torch.int64, device=s.device)
              * group_size)[:, None]
    ncand = groups * stage1_k
    return (v.reshape(b, r, ncand), gi.reshape(b, r, ncand).to(torch.int32))


def paged_gather_ref(pages: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """Gather a paged pool into per-slot contiguous logical order.

    pages: (n_pages, H_kv, page_size, ...); page_table: (B, NP) int32.
    Returns (B, H_kv, NP * page_size, ...).  Table entries are clamped
    into the pool, as the reference's gather clamps them.
    """
    pt = page_table.long().clamp(0, pages.shape[0] - 1)
    g = pages[pt]  # (B, NP, H_kv, page, ...)
    b, np_, hkv, page = g.shape[:4]
    return g.movedim(2, 1).reshape(b, hkv, np_ * page, *g.shape[4:])


def paged_flash_decode_ref(q_rows, k_pages, v_pages, page_table, kv_len,
                           q_pos, *, sq: int = 1, binary: bool = False,
                           window: int | None = None) -> torch.Tensor:
    """Online-softmax attention of pre-scaled query rows over the page
    table, one (B, H_kv, page, D) tile per logical page in order.

    q_rows: (B, H_kv, R, D) rows pre-scaled by the caller; for ``sq > 1``
    R = G * Sq with row r = g * sq + s anchored at ``q_pos[b] + s``.
    k_pages/v_pages: (P, H_kv, page, D[v]).  Returns (B, H_kv, R, Dv)
    float32; ``kv_len == 0`` rows are zeros.
    """
    b, hkv, rows, _ = q_rows.shape
    _, _, page, dv = v_pages.shape
    np_ = page_table.shape[1]
    dev = q_rows.device
    q = q_rows.to(torch.float32)
    pt = page_table.long().clamp(0, k_pages.shape[0] - 1)
    kvl = kv_len.reshape(b, 1, 1, 1)
    qp = q_pos.reshape(b, 1, 1, 1)
    if sq > 1:  # per-row intra-chunk causal anchors
        qp = qp + (torch.arange(rows, dtype=torch.int32, device=dev)
                   % sq).reshape(1, 1, rows, 1)
    m = torch.full((b, hkv, rows), NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, hkv, rows), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rows, dv), dtype=torch.float32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    offs = torch.arange(page, dtype=torch.int32, device=dev)
    for j in range(np_):
        phys = pt[:, j]
        k = k_pages[phys].to(torch.float32)  # (B, H_kv, page, D)
        v = v_pages[phys].to(torch.float32)
        if binary:
            k = torch.where(k > 0, 1.0, -1.0)  # sign_pm1 semantics
        s = torch.einsum("bhrd,bhpd->bhrp", q, k)
        kpos = (j * page + offs).reshape(1, 1, 1, page)
        ok = (kpos < kvl) & (kpos <= qp)
        if window is not None:
            ok = ok & (kpos > qp - window)
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        denom = denom * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhrp,bhpd->bhrd", p, v)
        m = m_new
    return acc / torch.clamp(denom, min=1e-30)[..., None]


def bacam_paged_topk_ref(q_packed, kp_pages, page_table, kv_len, d: int, *,
                         q_pos=None, group_size: int = 16, stage1_k: int = 2,
                         window: int | None = None):
    """Paged BA-CAM scoring + stage-1 top-k per group of keys.

    q_packed: (B, H_kv, R, W) int32; kp_pages: (P, H_kv, page, W) int32;
    page_table: (B, NP); kv_len: (B,); q_pos: (B,) (default kv_len - 1).
    Returns (cand_vals, cand_idx) of shape (B, H_kv, R,
    stage1_k * NP * page / group) int32, logical-page-major; masked
    candidates hold MASKED_SCORE and ties go to the lowest key index.
    """
    b, hkv, r, _ = q_packed.shape
    kp = paged_gather_ref(kp_pages, page_table)  # (B, H_kv, S_log, W)
    s_log = kp.shape[2]
    s = hamming_scores_packed(q_packed, kp, d)  # (B, H_kv, R, S_log)
    if q_pos is None:
        q_pos = kv_len - 1
    kpos = torch.arange(s_log, dtype=torch.int32, device=s.device)
    qpos = q_pos.reshape(b, 1, 1, 1)
    ok = (kpos < kv_len.reshape(b, 1, 1, 1)) & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok, s, torch.full_like(s, MASKED_SCORE))
    groups = s_log // group_size
    v, i = stable_topk(s.reshape(b, hkv, r, groups, group_size), stage1_k)
    gi = i + (torch.arange(groups, dtype=torch.int64, device=s.device)
              * group_size)[:, None]
    ncand = groups * stage1_k
    return (v.reshape(b, hkv, r, ncand),
            gi.reshape(b, hkv, r, ncand).to(torch.int32))


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        scale: float | None = None,
                        window: int | None = None) -> torch.Tensor:
    """Naive softmax attention in float32, per-head (B, S, D) layout.

    q: (B, Sq, D); k, v: (B, Skv, D); q row i sits at position
    ``q_offset + i``.  Returns (B, Sq, D) in q's dtype.  A row with no
    valid key averages V uniformly here, where the flash kernels return
    zeros; the two agree wherever each row sees a key (every row when
    ``q_offset + Sq <= Skv``).
    """
    sq, d = q.shape[1], q.shape[2]
    skv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qpos = (torch.arange(sq, dtype=torch.int32, device=q.device)[:, None]
            + int(q_offset))
    kpos = torch.arange(skv, dtype=torch.int32, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.to(torch.float32)).to(q.dtype)


def bitslice_vmm_ref(x, w_int, bits: int) -> torch.Tensor:
    """Exact binary-integer VMM ``x @ w_int^T``.

    x: (B, R, d) in {-1, +1}; w_int: (B, N, d) integers representable in
    ``bits`` two's-complement bits.  Returns (B, R, N) int32.  The product
    runs in float64, exact for any |sum| < 2**53 (CUDA has no integer
    matmul).
    """
    y = torch.einsum("brd,bnd->brn", x.to(torch.float64),
                     w_int.to(torch.float64))
    return y.to(torch.int32)


def int_slices(w_int, bits: int) -> torch.Tensor:
    """Two's-complement bit planes of w_int: (bits, ...) int32 in {0, 1}."""
    u = w_int.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([(u >> s) & 1 for s in range(bits)]).to(torch.int32)
