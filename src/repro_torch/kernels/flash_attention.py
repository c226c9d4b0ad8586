"""Contiguous flash attention forward, CUDA on the card.

Replaces the TPU kernel ``kernels/flash_attention.py::flash_attention``
of the reference package with two CUDA kernels, one per input type:
``csrc/flash_attention.cu`` (bf16: wgmma tensor-core tiles fed by a TMA
ring) and ``csrc/flash_attention_f32.cu`` (float32: 3xTF32 mma.sync
fragments, double-buffered with cp.async).  Their headers state the
designs.

Bound on the card at (128, 1024, 64), causal: in bf16 the 67 MB of q, k,
v and out (20 us at 3.35 TB/s) against 17.2 GFLOP (17 us at 989
TFLOP/s); in float32, computed as 3xTF32, 51.6 GFLOP of TF32 products
(104 us at 495 TFLOP/s) against 134 MB (40 us).

A tensor on the CPU takes the plain version (``ref.flash_attention_ref``);
a CUDA tensor launches the kernel or raises.  The two agree wherever
every row sees a key (``q_offset + Sq <= Skv`` under causal masking);
a row with no valid key is zero from the kernel.  ``launches`` counts
kernel launches of either type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "launches"]

launches = 0  # kernel launches (plain-version calls are not counted)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, *, causal: bool = True,
                    window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Flash attention forward. q: (B, Sq, D); k, v: (B, Skv, D), all
    float32 or all bfloat16; query row i sits at ``q_offset + i``.
    Returns (B, Sq, D) in q's dtype, computed in float32."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal,
                                   q_offset=int(q_offset), scale=scale,
                                   window=window)
    global launches
    b, sq, d = q.shape
    skv = k.shape[1]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: float32 or bfloat16 only")
    build.check("q", q, dev, q.dtype, (b, sq, d))
    build.check("k", k, dev, q.dtype, (b, skv, d))
    build.check("v", v, dev, q.dtype, (b, skv, d))
    if d > 256:
        raise ValueError(f"head dim D={d} must be <= 256")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's 65535 batches")
    if q.numel() == 0 or skv == 0:  # no row, or no key for any row
        return torch.zeros_like(q)
    # the kernels read rows in 16-byte pieces: pad D with zero columns to
    # a multiple of 8 (bf16) or 4 (f32), and start each tensor 16-byte
    # aligned
    step = 8 if q.dtype == torch.bfloat16 else 4
    dp = -(-d // step) * step
    q, k, v = (build.aligned(F.pad(t, (0, dp - d)) if dp != d else t)
               for t in (q, k, v))
    out = torch.empty_like(q)
    symbol = ("flash_attention" if q.dtype == torch.bfloat16
              else "flash_attention_f32")
    with torch.cuda.device(dev):
        err = build.entry(symbol, symbol, 4, 8, 1)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, dp, int(q_offset), int(causal), int(window is not None),
            int(window or 0), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    launches += 1
    return out[..., :d].contiguous() if dp != d else out
