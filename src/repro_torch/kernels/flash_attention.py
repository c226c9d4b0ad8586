"""Contiguous flash attention forward, CUDA on the card.

Replaces the TPU kernel ``kernels/flash_attention.py::flash_attention``
of the reference package.  The CUDA source is ``csrc/flash_attention.cu``;
its header states the design.

Bound on the card: at (128, 1024, 64), causal, the function does 17.2
GFLOP of causally valid f32 work, about 256 us at 67 TFLOP/s, against
about 30 us of bytes: it is bounded by operations.  The kernel bounds
its key loop by the causal (and window) limits of each row tile.

A tensor on the CPU takes the plain version (``ref.flash_attention_ref``);
a CUDA tensor launches the kernel or raises.  The two agree wherever
every row sees a key (``q_offset + Sq <= Skv`` under causal masking);
a row with no valid key is zero from the kernel.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = build.entry("flash_attention", "flash_attention", 4, 9, 1)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, d, int(q_offset), int(causal), int(window is not None),
            int(window or 0), int(q.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
