"""Paged flash attention (decode rows and chunk rows), CUDA on the card.

Replaces the TPU kernel ``kernels/paged_flash_decode.py::paged_flash_decode``
of the reference package, in both its forms: ``sq == 1`` (dense decode)
and ``sq > 1`` (chunked prefill, R = G * Sq rows).  The CUDA source is
``csrc/paged_flash_decode.cu``; its header states the design.

Bound on the card: at 8 slots x 512 tokens the live bf16 K+V are about
16.8 MB per layer, about 5 us at 3.35 TB/s, so decode rows are bounded
by bytes.  A prefill chunk of 384 rows over prompts of 64-384 tokens
does about 1.8 GFLOP of causally valid f32 work per layer, about 27 us
at 67 TFLOP/s against about 10 us of bytes, so it is bounded by
operations.  The kernel reads only the slot's live pages and keeps the
running softmax state in registers, with no logical-order K/V gather.

A tensor on the CPU takes the plain version
(``ref.paged_flash_decode_ref``); a CUDA tensor launches the kernel or
raises.  ``launches`` counts kernel launches, ``prefill_launches`` those
with ``sq > 1``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_flash_decode_ref

__all__ = ["paged_flash_decode", "paged_flash_decode_ref", "launches",
           "prefill_launches"]

launches = 0  # kernel launches (plain-version calls are not counted)
prefill_launches = 0  # the sq > 1 subset of ``launches``


def paged_flash_decode(q_rows, k_pages, v_pages, page_table, kv_len, q_pos, *,
                       sq: int = 1, binary: bool = False,
                       window: int | None = None) -> torch.Tensor:
    """Fused paged flash attention over one layer's K/V page pools.

    q_rows: (B, H_kv, R, D) float32 rows, PRE-SCALED by the caller; for
    ``sq > 1`` R = G * Sq with row r = g * sq + s at ``q_pos[b] + s``.
    k_pages/v_pages: (P, H_kv, page, D[v]) bf16 or f32 (one dtype);
    page_table: (B, NP) int32; kv_len, q_pos: (B,) int32.  Returns
    (B, H_kv, R, Dv) float32; ``kv_len == 0`` rows are zeros.
    """
    if not q_rows.is_cuda:
        return paged_flash_decode_ref(
            q_rows, k_pages, v_pages, page_table, kv_len, q_pos, sq=sq,
            binary=binary, window=window)
    global launches, prefill_launches
    b, hkv, rows, d = q_rows.shape
    n_pages, _, page, dv = v_pages.shape
    np_ = page_table.shape[1]
    dev = q_rows.device
    if k_pages.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k_pages dtype {k_pages.dtype}: bf16 or f32 only")
    build.check("q_rows", q_rows, dev, torch.float32, (b, hkv, rows, d))
    build.check("k_pages", k_pages, dev, k_pages.dtype,
                (n_pages, hkv, page, d))
    build.check("v_pages", v_pages, dev, k_pages.dtype,
                (n_pages, hkv, page, dv))
    build.check("page_table", page_table, dev, torch.int32, (b, np_))
    build.check("kv_len", kv_len, dev, torch.int32, (b,))
    build.check("q_pos", q_pos, dev, torch.int32, (b,))
    if rows % sq:
        raise ValueError(f"rows={rows} must be a multiple of sq={sq}")
    if dv > 256 or d > 256:
        raise ValueError(f"head dims D={d}, Dv={dv} must be <= 256")
    out = torch.empty((b, hkv, rows, dv), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = build.entry("paged_flash_decode", "paged_flash_decode", 7,
                          13)(
            q_rows.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), b, hkv, rows, d, dv, n_pages, page, np_, sq,
            int(binary), int(window is not None), int(window or 0),
            int(k_pages.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error "
                           f"{err}")
    launches += 1
    prefill_launches += sq > 1
    return out
