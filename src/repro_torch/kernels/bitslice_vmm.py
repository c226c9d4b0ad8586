"""Bit-sliced binary-integer VMM (paper Sec. II-B1), CUDA on the card.

Replaces ``kernels/bitslice_vmm.py::bitslice_vmm`` of the reference
package, which has no ``pallas_call`` of its own: it loops the BA-CAM
matrix kernel over the bit planes of an integer operand.  For x in
{-1, +1}^d and a {0, 1} plane p (p± = 2p - 1),

    x . p = (x . p± + x . 1) / 2,

so each plane costs one BA-CAM search plus one shared row sum, and the
two's-complement MSB plane enters with weight -2^(bits-1).
:func:`plane_loop` keeps that per-plane arithmetic (on the CPU through
the plain BA-CAM matrix product, so the CPU tests hold it against JAX).

On the card the same exact int32 product is one launch of
``csrc/bitslice_vmm.cu``, which multiplies byte limbs of w on the int8
tensor cores and writes y once; its header states the design.  Bound on
the card: at (128, 896, 64) x (128, 896, 64) the int32 output (411 MB)
against 59 MB of inputs, about 140 us at 3.35 TB/s.

A tensor on the CPU takes the plain version (``ref.bitslice_vmm_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.bacam import pack_bits
from repro_torch.kernels import bacam_mvm as _mvm
from repro_torch.kernels import build
from repro_torch.kernels.ref import bitslice_vmm_ref

__all__ = ["bitslice_vmm", "bitslice_vmm_ref", "plane_loop", "launches"]

launches = 0  # kernel launches (plain-version calls are not counted)


def bitslice_vmm(x_pm1: torch.Tensor, w_int: torch.Tensor, *,
                 bits: int) -> torch.Tensor:
    """y = x_pm1 @ w_int^T, exact.

    x_pm1: (B, R, d) in {-1, +1}; w_int: (B, N, d) integers in
    [-2^(bits-1), 2^(bits-1)).  Returns (B, R, N) int32.  On the card
    d = 32 * W with 1 <= W <= 8 and 1 <= bits <= 32; x is read as
    ``x > 0`` (as ``pack_bits`` reads it) and w through its low ``bits``
    bits.
    """
    if not x_pm1.is_cuda:
        return bitslice_vmm_ref(x_pm1, w_int, bits)
    global launches
    b, r, d = x_pm1.shape
    n = w_int.shape[1]
    dev = x_pm1.device
    if d % 32 or not 1 <= d // 32 <= 8:
        raise ValueError(f"d={d} must be 32 * W with 1 <= W <= 8")
    if not 1 <= bits <= 32:
        raise ValueError(f"bits={bits} must be in [1, 32]")
    if b > 65535 or -(-r // 64) > 65535:
        raise ValueError(f"B={b}, R={r} exceed the grid")
    # the kernel reads 16 bytes at a time: f32 x and int32 w, 16-byte aligned
    x = build.aligned(x_pm1.to(torch.float32).contiguous())
    w = build.aligned(w_int.to(torch.int32).contiguous())
    build.check("x_pm1", x, dev, torch.float32, (b, r, d))
    build.check("w_int", w, dev, torch.int32, (b, n, d))
    out = torch.empty((b, r, n), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = build.entry("bitslice_vmm", "bitslice_vmm", 3, 5)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, r, n, d, bits,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"bitslice_vmm launch failed: CUDA error {err}")
    launches += 1
    return out


def plane_loop(x_pm1: torch.Tensor, w_int: torch.Tensor, *,
               bits: int) -> torch.Tensor:
    """The per-plane BA-CAM arithmetic: one ``bacam_mvm`` per bit plane
    (its kernel on a CUDA tensor, its plain version on a CPU one) and a
    shifted combine.  The reference's loop, kept as the arithmetic the
    CPU tests hold against JAX; ``bitslice_vmm`` does not call it."""
    d = x_pm1.shape[-1]
    xp = pack_bits(x_pm1)  # packed once, shared by every plane
    row_sum = x_pm1.to(torch.int32).sum(dim=-1)[:, :, None]  # x . 1
    u = w_int.to(torch.int64) & 0xFFFFFFFF  # two's-complement bits
    out = None
    for s in range(bits):
        plane = pack_bits((u >> s) & 1)
        dot = _mvm.bacam_mvm(xp, plane, d=d)  # x . p±
        # x . p = (x . p± + x . 1) // 2, exact (same parity); a shift is
        # the floor division by 2, done in place on the kernel's output
        dot.add_(row_sum).bitwise_right_shift_(1)
        weight = -(1 << s) if s == bits - 1 else (1 << s)
        if out is None:
            out = dot.mul_(weight)
        else:
            out.add_(dot, alpha=weight)
    return out
