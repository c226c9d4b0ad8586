"""HAD-style binarization of attention queries/keys.

CAMformer consumes the sign bits of Q and K; the per-vector L1 scale only
enters the softmax as a temperature, never the ordering of scores.

Training support: ``sign_ste`` is the straight-through estimator of HAD
(the gradient passes unchanged where |x| <= 1, zero elsewhere).  On the
exact BA-CAM path the signs are packed into integer words before the
scores are formed, which cuts that gradient: Q and K then learn only
through the HAD scales, with ``trainable=True`` as without it (as in the
reference).
"""

from __future__ import annotations

import torch

__all__ = ["sign_pm1", "sign_ste", "had_scales", "binarize_qk"]


def sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """Strict sign into {-1, +1}: ``x > 0`` maps to +1 and everything
    else, zero included, maps to -1 (the bit ``pack_bits`` stores)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, -one)


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return sign_pm1(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """``sign_pm1(x)`` with a straight-through gradient: ``g`` inside the
    clip region |x| <= 1, zero outside (HAD / BinaryConnect)."""
    return _SignSTE.apply(x)


def had_scales(x: torch.Tensor, dim: int = -1,
               keepdim: bool = True) -> torch.Tensor:
    """Per-vector L1 scale alpha = mean(|x|) (XNOR-Net / HAD analytic
    scale)."""
    return x.abs().mean(dim=dim, keepdim=keepdim)


def binarize_qk(q: torch.Tensor, k: torch.Tensor, *, trainable: bool = False,
                with_scales: bool = True):
    """Binarize query/key tensors for the BA-CAM path: ``sign_ste``
    (``trainable``) or ``sign_pm1``.

    Returns (qb, kb) in {-1, +1} with each input's dtype and, with
    ``with_scales``, also the HAD scales (q_scale, k_scale) of shape
    (..., 1) in each input's dtype.
    """
    fn = sign_ste if trainable else sign_pm1
    qb, kb = fn(q), fn(k)
    if not with_scales:
        return qb, kb
    return qb, kb, had_scales(q), had_scales(k)
