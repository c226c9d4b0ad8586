"""BA-CAM binary matrix product (the full score matrix), CUDA on the card.

Replaces the TPU kernel ``kernels/bacam_mvm.py::bacam_mvm`` of the
reference package.  The CUDA source is ``csrc/bacam_mvm.cu``; its header
states the two designs (tensor cores, with an s8 and a b1 product, and
popc for few rows) and the rule that picks one from the shapes.

Bound on the card: the int32 output dominates.  At the contiguous
prefill of camformer-bert (B * H_kv = 128, R = Skv = 896, d = 64) the
kernel writes 411 MB of scores from 1.8 MB of packed operands, about
123 us at 3.35 TB/s.

A tensor on the CPU takes the plain version (``ref.bacam_scores_ref``);
a CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches, and ``shape_launches`` the same launches by (B, R, Skv, W).
``plan`` names the design the source picks for a shape, and ``launch``
runs one named design, uncounted (for timing and tests).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bacam_scores_ref

__all__ = ["bacam_mvm", "bacam_scores_ref", "launches", "shape_launches",
           "DESIGNS", "plan", "launch"]

DESIGNS = ("tensor cores s8", "tensor cores b1", "popc")  # the source's order
launches = 0  # kernel launches (plain-version calls are not counted)
shape_launches: Counter = Counter()  # the launches by (B, R, Skv, W)


@functools.lru_cache(maxsize=None)
def plan(r: int, words: int) -> int:
    """The design (an index of ``DESIGNS``) the source's ``bacam_mvm``
    runs for R query rows of W words.  Builds the library at its first
    call, so it runs on the card only."""
    fn = build.load("bacam_mvm").bacam_mvm_plan
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(r, words)


def _run(q_packed, k_packed, d, design):
    b, r, words = q_packed.shape
    skv = k_packed.shape[1]
    dev = q_packed.device
    build.check("q_packed", q_packed, dev, torch.int32, (b, r, words))
    build.check("k_packed", k_packed, dev, torch.int32, (b, skv, words))
    if words * 32 != d or not 1 <= words <= 8:
        raise ValueError(f"d={d} must be 32 * W with 1 <= W <= 8, got "
                         f"W={words}")
    if b > 65535:
        raise ValueError(f"B={b} exceeds the grid's 65535 batches")
    out = torch.empty((b, r, skv), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    args = (q_packed.data_ptr(), k_packed.data_ptr(), out.data_ptr(), b, r,
            skv, words, d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design is None:
            err = build.entry("bacam_mvm", "bacam_mvm", 3, 5)(*args, stream)
        else:
            err = build.entry("bacam_mvm", "bacam_mvm_design", 3, 6)(
                *args, design, stream)
    if err:
        raise RuntimeError(f"bacam_mvm launch failed: CUDA error {err}")
    return out


def bacam_mvm(q_packed: torch.Tensor, k_packed: torch.Tensor, *,
              d: int) -> torch.Tensor:
    """Binary scores (B, R, Skv) int32 from packed (B, R, W) and
    (B, Skv, W) int32 operands: ``d - 2 * popcount(q ^ k)``, any R, Skv
    and W = d / 32 <= 8 (no padding)."""
    if not q_packed.is_cuda:
        return bacam_scores_ref(q_packed, k_packed, d)
    global launches
    out = _run(q_packed, k_packed, d, None)
    if out.numel():
        launches += 1
        b, r, words = q_packed.shape
        shape_launches[(b, r, k_packed.shape[1], words)] += 1
    return out


def launch(q_packed: torch.Tensor, k_packed: torch.Tensor, *, d: int,
           design: int) -> torch.Tensor:
    """One launch of the named design (an index of ``DESIGNS``) on card
    tensors, counted nowhere."""
    if not q_packed.is_cuda:
        raise ValueError("launch takes CUDA tensors only")
    if not 0 <= design < len(DESIGNS):
        raise ValueError(f"design={design} is not one of {DESIGNS}")
    return _run(q_packed, k_packed, d, design)
