"""Bit-sliced binary-integer VMM on the BA-CAM kernel (paper Sec. II-B1).

Replaces ``kernels/bitslice_vmm.py::bitslice_vmm`` of the reference
package, which has no ``pallas_call`` of its own: it loops the BA-CAM
matrix kernel over the bit planes of an integer operand.  Here the loop
launches the CUDA kernel of ``kernels/bacam_mvm.py`` once per plane.
For x in {-1, +1}^d and a {0, 1} plane p (p± = 2p - 1),

    x . p = (x . p± + x . 1) / 2,

so each plane costs one BA-CAM search plus one shared row sum, and the
two's-complement MSB plane enters with weight -2^(bits-1).  The x
operand is packed once; the kernel masks its own ragged edge, so no
padding is needed.

A tensor on the CPU takes the plain version (``ref.bitslice_vmm_ref``);
a CUDA tensor runs the loop of kernel launches.  ``launches`` counts the
calls that ran the loop (each is ``bits`` BA-CAM launches).
"""

from __future__ import annotations

import torch

from repro_torch.core.bacam import pack_bits
from repro_torch.kernels import bacam_mvm as _mvm
from repro_torch.kernels.ref import bitslice_vmm_ref

__all__ = ["bitslice_vmm", "bitslice_vmm_ref", "plane_loop", "launches"]

launches = 0  # calls that ran the kernel loop (plain calls not counted)


def bitslice_vmm(x_pm1: torch.Tensor, w_int: torch.Tensor, *,
                 bits: int) -> torch.Tensor:
    """y = x_pm1 @ w_int^T by per-plane BA-CAM searches.

    x_pm1: (B, R, d) in {-1, +1}; w_int: (B, N, d) integers in
    [-2^(bits-1), 2^(bits-1)).  Returns (B, R, N) int32, exact.
    """
    if not x_pm1.is_cuda:
        return bitslice_vmm_ref(x_pm1, w_int, bits)
    global launches
    out = plane_loop(x_pm1, w_int, bits=bits)
    launches += 1
    return out


def plane_loop(x_pm1: torch.Tensor, w_int: torch.Tensor, *,
               bits: int) -> torch.Tensor:
    """The per-plane loop over ``bacam_mvm`` (the kernel on a CUDA tensor,
    its plain version on a CPU one, so the loop's arithmetic is testable
    on the CPU)."""
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
