"""Threefry-2x32 keyed draws in PyTorch integer ops.

The reference engine samples with ``jax.random.categorical`` under
``jax_threefry_partitionable=True``.  The functions here compute the same
bits from the same raw keys, so a draw is the same pure function of
``(key, index)`` on both packages:

* ``threefry2x32`` — the 20-round Threefry-2x32 block cipher (5 blocks of
  4 rounds, rotations 13 15 26 6 / 17 29 16 24, key schedule with
  ``k1 ^ k2 ^ 0x1BD11BDA``);
* ``fold_in`` — ``threefry2x32(key, (0, data))``: the data seeds a 64-bit
  counter whose high word is 0;
* ``random_bits`` — partitionable 32-bit bits of a flat shape ``(n,)``:
  element i hashes the counter ``(0, i)`` and XORs the two output words;
* ``uniform_tiny`` — the bits to a float in ``[tiny, 1)``: the top 23 bits
  as the mantissa of a float in ``[1, 2)``, minus 1, then
  ``max(tiny, f * (1 - tiny) + tiny)``;
* ``gumbel`` — ``-log(-log(u))`` (the ``"low"`` mode, the default);
* ``categorical`` — ``argmax(gumbel + logits)``, the first index on ties;
* ``normal`` — ``jax.random.normal(key, shape)`` in float32: the bits of
  the whole shape's flat row-major index, mapped onto
  ``[nextafter(-1, 0), 1)`` as ``jax.random.uniform`` maps them, then
  ``sqrt(2) * erfinv(u)`` with XLA's float32 ``ErfInv`` (Giles'
  polynomials, split at ``w = -log1p(-u**2) < 5``), not
  ``torch.erfinv``, which uses another algorithm.

torch has no uint32 arithmetic, so a word is an int64 holding the uint32
value and every add and rotate is masked back to 32 bits.  Keys are
``(..., 2)`` int64 tensors of those words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "fold_in", "random_bits", "uniform_tiny",
           "gumbel", "categorical", "erfinv_f32", "normal"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
# XLA's float32 ErfInv coefficients, highest degree first: w < 5, else
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words (x1, x2) under the key words
    (k1, k2); every argument an int64 tensor of uint32 values, all
    broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROT[block % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(block + 1) % 3]) & _MASK
        x2 = (x2 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x1, x2


def fold_in(keys, data):
    """``jax.random.fold_in`` of raw keys (..., 2) with int data (...):
    returns the new keys (..., 2)."""
    data = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys, n: int):
    """Partitionable 32-bit random bits (..., n) of raw keys (..., 2), as
    ``jax.random.bits(key, (n,))`` gives them (n < 2**32)."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(count), count)
    return b1 ^ b2


def uniform_tiny(bits):
    """Uniform floats in [tiny, 1) from 32-bit bits (int64 words), as
    ``jax.random.uniform(key, minval=finfo.tiny, maxval=1.0)`` maps them."""
    one = torch.tensor(1.0, dtype=torch.float32, device=bits.device)
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=bits.device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - one
    return torch.maximum(tiny, f * (one - tiny) + tiny)


def gumbel(keys, n: int):
    """Standard Gumbel noise (..., n) float32 of raw keys (..., 2), as
    ``jax.random.gumbel(key, (n,))`` in its default ``"low"`` mode."""
    return -torch.log(-torch.log(uniform_tiny(random_bits(keys, n))))


def categorical(keys, logits):
    """``jax.random.categorical(key, row)`` for every row of logits
    (..., V) float32 with its own raw key (..., 2): int64 indices."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def erfinv_f32(x):
    """XLA's float32 ``ErfInv`` of x in [-1, 1], step for step: w =
    -log1p(-x * x); a degree-8 polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3 (else) in Horner order, one fused multiply-add a step;
    times x; +-inf at +-1.  ``log1p`` is the C library's (CPU) or CUDA's
    (card), each within an ulp or two of XLA's: the only source of
    difference from the reference."""
    w = -torch.log1p(x * -x)
    lt = w < _f32(5.0, x)
    t = torch.where(lt, w - _f32(2.5, x), torch.sqrt(w) - _f32(3.0, x))
    coef = [torch.where(lt, _f32(a, x), _f32(b, x))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    # XLA compiles each Horner step into a fused multiply-add: in float64
    # the product of two floats is exact, so one rounding to float64 and
    # one to float32 give the FMA's result (but where the first rounding
    # lands on a float32 halfway point, about 2**-29 of the steps)
    t64 = t.to(torch.float64)
    p = coef[0]
    for c in coef[1:]:
        p = (p.to(torch.float64) * t64 + c.to(torch.float64)).to(
            torch.float32)
    return torch.where(x.abs() == _f32(1.0, x), x * _f32(float("inf"), x),
                       p * x)


def normal(keys, shape, scale: float = 1.0):
    """Standard normals of ``shape`` float32 from one raw key (2,), as
    ``jax.random.normal(key, shape)`` draws them: partitionable bits over
    the flat row-major index of the whole shape (the same draw on a
    different shape or order lands on other elements).

    ``scale`` multiplies them as a jitted ``scale * normal(...)`` does:
    XLA folds the two constants, so erfinv(u) is multiplied once, by the
    float32 product of ``scale`` and sqrt(2)."""
    shape = tuple(int(n) for n in shape)
    bits = random_bits(keys.to(torch.int64), math.prod(shape))
    lo = _f32(float(np.nextafter(np.float32(-1.0), np.float32(0.0))), bits)
    hi = _f32(1.0, bits)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - hi
    u = torch.maximum(lo, f * (hi - lo) + lo)
    factor = _f32(scale, bits) * _f32(float(np.float32(np.sqrt(2.0))), bits)
    return (factor * erfinv_f32(u)).reshape(shape)
