"""Paged flash attention (decode rows and chunk rows), CUDA on the card.

Replaces the TPU kernel ``kernels/paged_flash_decode.py::paged_flash_decode``
of the reference package, in both its forms: ``sq == 1`` (dense decode)
and ``sq > 1`` (chunked prefill, R = G * Sq rows).  The CUDA source is
``csrc/paged_flash_decode.cu``; it picks one of three designs per call
from the shapes, and its header states them:

* split-KV decode rows (sq == 1, R <= 8), one page a split, then a merge
  kernel.  Bounded by bytes: the paged path's decode step reads 1,920
  live keys x 16 kv heads of bf16 K+V, 7.86 MB, 2.35 us at 3.35 TB/s.
* 64-row chunk tiles (bf16 pools, D == Dv in {32, 64, 128}): scores in
  f32 FMA, P V on the tensor cores.  The path's 384-row chunk is bounded
  by its f32 scores: 0.89 GFLOP, 13.3 us at 67 TFLOP/s, against 32.5 MB
  of q, out and K/V, 9.7 us.
* SIMT rows for everything else (e.g. f32 pools at sq > 1).

The kernels read only the slot's live pages and keep no logical-order K/V
gather.  A tensor on the CPU takes the plain version
(``ref.paged_flash_decode_ref``); a CUDA tensor launches the kernel or
raises.  ``launches`` counts wrapper calls that launched (one each, though
the split design launches a merge kernel too), ``prefill_launches`` those
with ``sq > 1``, ``binary_launches`` the binary-mode decode rows
(``sq == 1``, the binary backend and the speculative drafter), and
``sq_launches`` the ``sq > 1`` launches by chunk length (a speculative
verify chunk has ``spec_k + 1`` rows).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_flash_decode_ref

__all__ = ["paged_flash_decode", "paged_flash_decode_ref", "launch", "plan",
           "DESIGNS", "launches", "prefill_launches", "binary_launches",
           "sq_launches"]

DESIGNS = ("split-KV", "chunk tiles", "SIMT")  # by the source's number

launches = 0  # calls that launched (plain-version calls are not counted)
prefill_launches = 0  # the sq > 1 subset of ``launches``
binary_launches = 0  # the binary-mode sq == 1 subset of ``launches``
sq_launches = collections.Counter()  # {sq: launches} of the sq > 1 subset


@functools.lru_cache(maxsize=None)
def plan(b: int, hkv: int, rows: int, d: int, dv: int, page: int, np_: int,
         sq: int, is_bf16: bool, split_pages: int = 1) -> tuple[int, int]:
    """(design, workspace floats) of one call, as the source's
    ``paged_flash_plan`` decides them; the design indexes ``DESIGNS``.
    Builds the library at its first call, so it runs on the card only."""
    fn = build.load("paged_flash_decode").paged_flash_plan
    fn.argtypes = [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    ws = ctypes.c_longlong(0)
    design = fn(b, hkv, rows, d, dv, page, np_, sq, int(is_bf16),
                split_pages, ctypes.byref(ws))
    return design, ws.value


def paged_flash_decode(q_rows, k_pages, v_pages, page_table, kv_len, q_pos, *,
                       sq: int = 1, binary: bool = False,
                       window: int | None = None) -> torch.Tensor:
    """Fused paged flash attention over one layer's K/V page pools.

    q_rows: (B, H_kv, R, D) float32 rows, PRE-SCALED by the caller; for
    ``sq > 1`` R = G * Sq with row r = g * sq + s at ``q_pos[b] + s``.
    k_pages/v_pages: (P, H_kv, page, D[v]) bf16 or f32 (one dtype);
    page_table: (B, NP) int32; kv_len, q_pos: (B,) int32.  Returns
    (B, H_kv, R, Dv) float32; ``kv_len == 0`` rows are zeros.
    """
    if not q_rows.is_cuda:
        return paged_flash_decode_ref(
            q_rows, k_pages, v_pages, page_table, kv_len, q_pos, sq=sq,
            binary=binary, window=window)
    global launches, prefill_launches, binary_launches
    out = launch(q_rows, k_pages, v_pages, page_table, kv_len, q_pos, sq=sq,
                 binary=binary, window=window)
    launches += 1
    if sq > 1:
        prefill_launches += 1
        sq_launches[sq] += 1
    elif binary:
        binary_launches += 1
    return out


def launch(q_rows, k_pages, v_pages, page_table, kv_len, q_pos, *,
           sq: int = 1, binary: bool = False, window: int | None = None,
           split_pages: int = 1) -> torch.Tensor:
    """One launch of the CUDA entry on card tensors, counted nowhere; the
    wrapper calls it with one page a split (``split_pages``)."""
    if not q_rows.is_cuda:
        raise ValueError("launch takes CUDA tensors only")
    b, hkv, rows, d = q_rows.shape
    n_pages, _, page, dv = v_pages.shape
    np_ = page_table.shape[1]
    dev = q_rows.device
    if k_pages.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k_pages dtype {k_pages.dtype}: bf16 or f32 only")
    build.check("q_rows", q_rows, dev, torch.float32, (b, hkv, rows, d))
    build.check("k_pages", k_pages, dev, k_pages.dtype,
                (n_pages, hkv, page, d))
    build.check("v_pages", v_pages, dev, k_pages.dtype,
                (n_pages, hkv, page, dv))
    build.check("page_table", page_table, dev, torch.int32, (b, np_))
    build.check("kv_len", kv_len, dev, torch.int32, (b,))
    build.check("q_pos", q_pos, dev, torch.int32, (b,))
    if rows % sq:
        raise ValueError(f"rows={rows} must be a multiple of sq={sq}")
    if dv > 256 or d > 256:
        raise ValueError(f"head dims D={d}, Dv={dv} must be <= 256")
    out = torch.empty((b, hkv, rows, dv), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    is_bf16 = k_pages.dtype == torch.bfloat16
    _, ws_floats = plan(b, hkv, rows, d, dv, page, np_, sq, is_bf16,
                        split_pages)
    # the split kernel's (m, l, acc) per (slot, head, split, row)
    ws = (torch.empty(ws_floats, dtype=torch.float32, device=dev)
          if ws_floats else None)
    # the split-KV and chunk-tile kernels copy 16 bytes at a time
    q_rows, k_pages, v_pages = (build.aligned(t)
                                for t in (q_rows, k_pages, v_pages))
    with torch.cuda.device(dev):
        err = build.entry("paged_flash_decode", "paged_flash_decode", 8,
                          14)(
            q_rows.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), b, hkv,
            rows, d, dv, n_pages, page, np_, sq, int(binary),
            int(window is not None), int(window or 0), int(is_bf16),
            split_pages, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error "
                           f"{err}")
    return out
