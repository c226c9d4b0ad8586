"""HAD-style binarization of attention queries/keys (inference half).

CAMformer consumes the sign bits of Q and K; the per-vector L1 scale only
enters the softmax as a temperature, never the ordering of scores.  The
straight-through estimator of training (``sign_ste``) is not ported yet:
``binarize_qk(trainable=True)`` raises.
"""

from __future__ import annotations

import torch

__all__ = ["sign_pm1", "had_scales", "binarize_qk"]


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


def binarize_qk(q: torch.Tensor, k: torch.Tensor, *, trainable: bool = False,
                with_scales: bool = True):
    """Binarize query/key tensors for the BA-CAM path.

    Returns (qb, kb) in {-1, +1} with each input's dtype and, with
    ``with_scales``, also the HAD scales (q_scale, k_scale) of shape
    (..., 1) in each input's dtype.
    """
    if trainable:
        raise NotImplementedError(
            "trainable binarization (the straight-through estimator) is "
            "not ported yet")
    qb, kb = sign_pm1(q), sign_pm1(k)
    if not with_scales:
        return qb, kb
    return qb, kb, had_scales(q), had_scales(k)
