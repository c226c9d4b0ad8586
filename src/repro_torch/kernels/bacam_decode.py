"""Paged BA-CAM decode: binary scoring + stage-1 top-k, CUDA on the card.

Replaces the TPU kernel ``kernels/bacam_decode.py::bacam_paged_topk_stage1``
of the reference package (body ``kernels/bacam_topk.py::score_and_stage1``).
The CUDA source is ``csrc/bacam_decode.cu`` over the device body it
shares with the contiguous kernel, ``csrc/bacam_stage1.cuh``; their
headers state the design.

Bound on the card: at the serving shapes (8 slots, 16 kv heads, 64-key
pages, one row per kv head) the live packed keys are about 0.5 MB per
layer, well under a microsecond of HBM time, so the kernel is bounded by
launch latency.  It runs as one launch per layer and writes only the
stage-1 candidates; the score matrix never reaches device memory.

A tensor on the CPU takes the plain version (``ref.bacam_paged_topk_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bacam_paged_topk_ref

__all__ = ["bacam_paged_topk_stage1", "bacam_paged_topk_ref", "launches"]

launches = 0  # kernel launches (plain-version calls are not counted)


def bacam_paged_topk_stage1(q_packed, kp_pages, page_table, kv_len, q_pos, *,
                            d: int, group: int = 16, stage1_k: int = 2,
                            window: int | None = None):
    """Fused paged binary scoring + stage-1 top-k for decode rows.

    q_packed: (B, H_kv, R, W) int32 packed query rows; kp_pages:
    (P, H_kv, page, W) int32 packed key pool; page_table: (B, NP) int32;
    kv_len, q_pos: (B,) int32.  Returns (cand_vals, cand_idx) of shape
    (B, H_kv, R, stage1_k * NP * page / group) int32, logical-page-major;
    masked candidates hold MASKED_SCORE (their indices are unspecified).
    """
    if not q_packed.is_cuda:
        return bacam_paged_topk_ref(
            q_packed, kp_pages, page_table, kv_len, d, q_pos=q_pos,
            group_size=group, stage1_k=stage1_k, window=window)
    global launches
    b, hkv, rows, words = q_packed.shape
    n_pages, _, page, _ = kp_pages.shape
    np_ = page_table.shape[1]
    dev = q_packed.device
    i32 = torch.int32
    build.check("q_packed", q_packed, dev, i32, (b, hkv, rows, words))
    build.check("kp_pages", kp_pages, dev, i32,
                (n_pages, hkv, page, words))
    build.check("page_table", page_table, dev, i32, (b, np_))
    build.check("kv_len", kv_len, dev, i32, (b,))
    build.check("q_pos", q_pos, dev, i32, (b,))
    if words * 32 != d or not 1 <= words <= 8:
        raise ValueError(f"d={d} must be 32 * W with 1 <= W <= 8, got "
                         f"W={words}")
    if group < 1 or group > 32 or group & (group - 1):
        raise ValueError(f"group={group} must be a power of two <= 32")
    if page % group or page > 1024:
        raise ValueError(f"page={page} must tile by group={group}, <= 1024")
    if not 1 <= stage1_k <= group:
        raise ValueError(f"stage1_k={stage1_k} must be in [1, group]")
    ncand = stage1_k * (page // group) * np_
    vals = torch.empty((b, hkv, rows, ncand), dtype=i32, device=dev)
    idx = torch.empty((b, hkv, rows, ncand), dtype=i32, device=dev)
    if vals.numel() == 0:
        return vals, idx
    with torch.cuda.device(dev):
        err = build.entry("bacam_decode", "bacam_paged_topk_stage1", 7,
                          12)(
            q_packed.data_ptr(), kp_pages.data_ptr(), page_table.data_ptr(),
            kv_len.data_ptr(), q_pos.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), b, hkv, rows, words, n_pages, page, np_, d,
            group, stage1_k, int(window is not None),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bacam_paged_topk_stage1 launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return vals, idx
