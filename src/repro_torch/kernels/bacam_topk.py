"""Contiguous BA-CAM association: scores + stage-1 top-k, CUDA on the card.

Replaces the TPU kernel ``kernels/bacam_topk.py::bacam_topk_stage1`` of
the reference package (body ``score_and_stage1``).  The CUDA source is
``csrc/bacam_topk.cu`` over the device body it shares with the paged
kernel, ``csrc/bacam_stage1.cuh``; their headers state the design.

Bound on the card: at a camformer-bert decode step (B * H_kv = 128, one
row, 1024 keys, d = 64) the kernel reads about 1 MiB of packed keys and
writes 128 KiB of candidates, a fraction of a microsecond at 3.35 TB/s,
so it is bounded by launch latency; at a 128-row prefill chunk the 16.8
MB of candidates it writes bound it at about 5.3 us, and its popcounts
at about 7 us.  Only the candidates reach device memory; the score
matrix never does.

A tensor on the CPU takes the plain version (``ref.bacam_topk_stage1_ref``
over the keys padded to a group multiple); a CUDA tensor launches the
kernel or raises.  ``launches`` counts kernel launches, and
``prefill_launches`` the subset whose rows hold more than one query
position (``sq > 1``: prefill chunks, not GQA decode rows).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bacam_topk_stage1_ref

__all__ = ["bacam_topk_stage1", "bacam_topk_stage1_plain", "launches",
           "prefill_launches"]

launches = 0  # kernel launches (plain-version calls are not counted)
prefill_launches = 0  # the sq > 1 subset of ``launches``


def bacam_topk_stage1_plain(q_packed, k_packed, q_pos, kv_len, *, d: int,
                            group: int = 16, stage1_k: int = 2,
                            causal: bool = True, window: int | None = None):
    """The kernel's plain version: keys padded with zero words to a group
    multiple, ``kv_len`` clamped to Skv so the padding is masked."""
    skv = k_packed.shape[1]
    pad = (-skv) % group
    if pad:
        k_packed = torch.nn.functional.pad(k_packed, (0, 0, 0, pad))
    kvl = torch.clamp(kv_len.reshape(-1).to(torch.int32), max=skv)
    return bacam_topk_stage1_ref(
        q_packed, k_packed, d, q_pos.to(torch.int32), group_size=group,
        stage1_k=stage1_k, causal=causal, window=window, kv_len=kvl)


def bacam_topk_stage1(q_packed, k_packed, q_pos, kv_len, *, d: int,
                      group: int = 16, stage1_k: int = 2, causal: bool = True,
                      window: int | None = None, sq: int | None = None):
    """Fused binary scores + stage-1 top-k over a contiguous packed cache.

    q_packed: (B, R, W) int32; k_packed: (B, Skv, W) int32 (any Skv);
    q_pos: (B, R) int32 query positions; kv_len: (B,) or (B, 1) int32
    valid keys.  sq: the query positions among the R rows, when they fold
    G GQA rows as R = G * sq (default R); only ``prefill_launches`` reads
    it.  Returns (cand_vals, cand_idx), both
    (B, R, stage1_k * ceil(Skv / group)) int32, group-major and
    top-k-minor; masked candidates hold MASKED_SCORE (their indices are
    don't-care and may reach past Skv in the last group).
    """
    if not q_packed.is_cuda:
        return bacam_topk_stage1_plain(
            q_packed, k_packed, q_pos, kv_len, d=d, group=group,
            stage1_k=stage1_k, causal=causal, window=window)
    global launches, prefill_launches
    b, r, words = q_packed.shape
    skv = k_packed.shape[1]
    dev = q_packed.device
    i32 = torch.int32
    kv_len = kv_len.reshape(-1)
    build.check("q_packed", q_packed, dev, i32, (b, r, words))
    build.check("k_packed", k_packed, dev, i32, (b, skv, words))
    build.check("q_pos", q_pos, dev, i32, (b, r))
    build.check("kv_len", kv_len, dev, i32, (b,))
    if words * 32 != d or not 1 <= words <= 8:
        raise ValueError(f"d={d} must be 32 * W with 1 <= W <= 8, got "
                         f"W={words}")
    if group < 1 or group > 32 or group & (group - 1):
        raise ValueError(f"group={group} must be a power of two <= 32")
    if not 1 <= stage1_k <= group:
        raise ValueError(f"stage1_k={stage1_k} must be in [1, group]")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's 65535 batches")
    ncand = stage1_k * (-(-skv // group))
    vals = torch.empty((b, r, ncand), dtype=i32, device=dev)
    idx = torch.empty((b, r, ncand), dtype=i32, device=dev)
    if vals.numel() == 0:
        return vals, idx
    with torch.cuda.device(dev):
        err = build.entry("bacam_topk", "bacam_topk_stage1", 6, 10)(
            q_packed.data_ptr(), k_packed.data_ptr(), q_pos.data_ptr(),
            kv_len.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, r, skv,
            words, d, group, stage1_k, int(causal), int(window is not None),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bacam_topk_stage1 launch failed: CUDA error "
                           f"{err}")
    launches += 1
    prefill_launches += (r if sq is None else sq) > 1
    return vals, idx
