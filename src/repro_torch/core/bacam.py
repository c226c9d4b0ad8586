"""BA-CAM scoring on bit-packed operands.

For ±1 vectors the ideal matchline result is the integer dot product

    dot(qb, kb) = d - 2 * popcount(q ^ k)

over sign bits packed 32 per word.  Words are stored as int32 tensors
that carry the same bits as the reference's uint32 words (PyTorch's
uint32 supports few operations); bit j of word w is element 32*w + j.

The device model (``bacam_scores(..., exact=False)``) is the paper's
analog BA-CAM: per ``cam_w``-bit vertical tile the matchline's match
count, optional matchline noise (``noise_sigma``, relative to full
scale, drawn as ``jax.random.normal(rng, ...)`` draws it:
serving/prng.py), a SAR ADC of ``adc_bits`` (``adc_readout``) and the
signed scores accumulated digitally across tiles (Fig. 4).  The
fidelity benchmarks use it; compute takes the exact integer path.
"""

from __future__ import annotations

import torch

__all__ = ["CAM_W", "CAM_H", "pack_bits", "unpack_bits", "popcount32",
           "hamming_scores_packed", "binary_scores_exact", "adc_readout",
           "bacam_scores"]

# The paper's array geometry (Sec. III-B1): 16 keys x 64 bits a tile.
CAM_W = 64  # bits per row == matchline width (a d_k tile)
CAM_H = 16  # keys per array (the stage-1 group size)

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


def binary_scores_exact(qb: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """Oracle: signed scores as a plain ±1 matmul, qb . kb (..., Sq, Sk)."""
    return torch.einsum("...qd,...kd->...qk", qb, kb)


def adc_readout(match_count: torch.Tensor, *, cam_w: int = CAM_W,
                bits: int = 6) -> torch.Tensor:
    """The SAR ADC digitizing one matchline: v = count / cam_w in
    [0, 1], code = round(v * (2**bits - 1)) clipped to the levels, and
    the count reconstructed as round(code * cam_w / (2**bits - 1)),
    float32.  Rounds half to even, as the reference's ``jnp.round``.
    At cam_w 64, 6 bits step 64/63 counts (sub-LSB error); 7 bits and
    more are exact."""
    levels = (1 << bits) - 1
    # a divisor on the device: CUDA turns division by a host scalar into
    # a reciprocal multiply
    v = match_count.to(torch.float32) / torch.full(
        (), float(cam_w), dtype=torch.float32, device=match_count.device)
    code = torch.clamp(torch.round(v * levels), 0, levels)
    return torch.round(code * (float(cam_w) / levels))


def _device_scores(qb, kb, cam_w, adc_bits, noise_sigma, rng):
    """The tiled device model of ``bacam_scores``: float32 (..., Sq, Sk)."""
    d = qb.shape[-1]
    if d % cam_w != 0:
        raise ValueError(f"d={d} must tile by cam_w={cam_w}")
    n_tiles = d // cam_w
    qt = qb.reshape(*qb.shape[:-1], n_tiles, cam_w)
    kt = kb.reshape(*kb.shape[:-1], n_tiles, cam_w)
    # matches per vertical tile, (dot + cam_w) / 2; the leading dims
    # broadcast (GQA's group axis)
    dots = torch.einsum("...qtc,...ktc->...qkt", qt, kt)
    matches = (dots + cam_w) * 0.5  # in [0, cam_w]
    if noise_sigma > 0.0:
        if rng is None:
            raise ValueError("noise_sigma > 0 requires rng")
        from repro_torch.serving.prng import normal  # local: no cycle

        noise = normal(torch.as_tensor(rng, device=matches.device),
                       matches.shape, scale=noise_sigma * cam_w)
        matches = torch.clamp(matches + noise, 0.0, float(cam_w))
    if adc_bits is not None:
        matches = adc_readout(matches, cam_w=cam_w, bits=adc_bits)
    # signed s = 2 * count - cam_w, accumulated digitally across tiles
    return (2.0 * matches - cam_w).sum(dim=-1).to(torch.float32)


def bacam_scores(qb: torch.Tensor, kb: torch.Tensor, *, cam_w: int = CAM_W,
                 adc_bits: int | None = None, noise_sigma: float = 0.0,
                 rng=None, exact: bool = True) -> torch.Tensor:
    """The BA-CAM device model for binary QK^T of ±1 tensors (..., Sq, d)
    / (..., Sk, d) (leading dims broadcast).

    With ``exact`` and neither ``adc_bits`` nor ``noise_sigma`` it is the
    exact integer path: (..., Sq, Sk) int32 in [-d, d] from the packed
    words.  Otherwise the device model, float32: d in ``cam_w``-bit
    tiles, match counts per tile, relative matchline noise
    ``noise_sigma`` (needs ``rng``, a raw key of two uint32 words as an
    int64 tensor (2,): the noise is ``jax.random.normal(rng,
    matches.shape)`` over the broadcast (..., Sq, Sk, tiles) shape), the
    ``adc_bits`` ADC, then the signed counts summed over the tiles.
    The ±1 operands are multiplied as floats there, so a straight-through
    sign's gradient reaches them (the packed exact path cuts it).
    """
    if exact and adc_bits is None and noise_sigma == 0.0:
        return hamming_scores_packed(pack_bits(qb), pack_bits(kb),
                                     qb.shape[-1])
    return _device_scores(qb, kb, cam_w, adc_bits, noise_sigma, rng)
