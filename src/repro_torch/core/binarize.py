"""HAD-style binarization of attention queries/keys (inference half).

CAMformer consumes the sign bits of Q and K; the per-vector L1 scale only
enters the softmax as a temperature, never the ordering of scores.
"""

from __future__ import annotations

import torch

__all__ = ["sign_pm1", "had_scales"]


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Strict sign into {-1, +1}: ``x > 0`` maps to +1 and everything
    else, zero included, maps to -1 (the bit ``pack_bits`` stores)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, -one)


def had_scales(x: torch.Tensor, dim: int = -1,
               keepdim: bool = True) -> torch.Tensor:
    """Per-vector L1 scale alpha = mean(|x|) (XNOR-Net / HAD analytic
    scale)."""
    return x.abs().mean(dim=dim, keepdim=keepdim)
