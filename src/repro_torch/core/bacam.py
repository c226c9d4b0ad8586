"""BA-CAM scoring on bit-packed operands.

For ±1 vectors the ideal matchline result is the integer dot product

    dot(qb, kb) = d - 2 * popcount(q ^ k)

over sign bits packed 32 per word.  Words are stored as int32 tensors
that carry the same bits as the reference's uint32 words (PyTorch's
uint32 supports few operations); bit j of word w is element 32*w + j.
"""

from __future__ import annotations

import torch

__all__ = ["pack_bits", "unpack_bits", "popcount32",
           "hamming_scores_packed", "bacam_scores"]

_MASK32 = 0xFFFFFFFF


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits of ``x`` (..., d) into int32 words (..., d//32).

    Bit j of word w is 1 iff x[..., 32*w + j] > 0 (zero packs as 0).
    """
    *lead, d = x.shape
    if d % 32 != 0:
        raise ValueError(f"packing requires d % 32 == 0, got d={d}")
    bits = (x > 0).to(torch.int64).reshape(*lead, d // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    # shifted bits occupy disjoint positions: the sum is the bitwise OR
    return _as_int32((bits << shifts).sum(dim=-1))


def unpack_bits(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` into {-1, +1} float32 (..., d)."""
    *lead, w = packed.shape
    if w * 32 != d:
        raise ValueError(f"packed width {w} inconsistent with d={d}")
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & _MASK32
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*lead, d).to(torch.float32) * 2.0 - 1.0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 input) as int32.

    SWAR in int64 after ``& 0xFFFFFFFF``: on int32, ``>>`` shifts
    arithmetically and the multiply step would overflow.
    """
    v = x.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _MASK32) >> 24).to(torch.int32)


def hamming_scores_packed(q_packed: torch.Tensor, k_packed: torch.Tensor,
                          d: int) -> torch.Tensor:
    """Signed binary scores from packed operands.

    q_packed: (..., Sq, W) int32; k_packed: (..., Sk, W) int32 (same
    leading dims).  Returns (..., Sq, Sk) int32 in [-d, d]:
    ``d - 2 * popcount(q ^ k)``.
    """
    x = torch.bitwise_xor(q_packed[..., :, None, :], k_packed[..., None, :, :])
    mismatches = popcount32(x).sum(dim=-1, dtype=torch.int32)
    return d - 2 * mismatches


def bacam_scores(qb: torch.Tensor, kb: torch.Tensor, *,
                 adc_bits: int | None = None, noise_sigma: float = 0.0,
                 exact: bool = True) -> torch.Tensor:
    """Binary QK^T of ±1 tensors (..., Sq, d) / (..., Sk, d) on the exact
    integer path: (..., Sq, Sk) int32 in [-d, d] (leading dims broadcast).

    The device-fidelity knobs of the reference (per-tile ADC readout
    ``adc_bits``, matchline noise ``noise_sigma``, ``exact=False``, with
    their ``cam_w`` tile width and noise ``rng``) serve only its fidelity
    benchmarks and are not ported yet: they raise.
    """
    if not exact or adc_bits is not None or noise_sigma != 0.0:
        raise NotImplementedError(
            "the BA-CAM device model (adc_bits / noise_sigma / exact=False) "
            "is not ported yet; only the exact integer path is")
    return hamming_scores_packed(pack_bits(qb), pack_bits(kb), qb.shape[-1])
