"""Build the CUDA sources of ``csrc/`` into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into ``build/lib<name>-<hash>.so`` at the repository root
and loaded with ``ctypes``; the hash covers the source, every shared header
``csrc/*.cuh`` and the flags, so an edited source or header never loads
a stale library.  Nothing is built when a
module is imported: the kernel wrappers call :func:`load` at their first
launch, and :func:`build` compiles several sources at once, one ``nvcc``
process each.  :func:`entry` binds one C function of a library, and
:func:`check` is the argument check every wrapper runs before a launch.

Debug build: with ``REPRO_TORCH_STAGE1_BOUNDS=1`` in the environment the
two BA-CAM stage-1 sources (``STAGE1_SOURCES``) are compiled with
``-DBACAM_STAGE1_BOUNDS``: every global load and store of their kernels
traps on an address outside its own tensor's extent (and every shared
tile store outside the tile), and each launch is synchronized, so a fault
reports on the launch that made it.  The flag is part of the library
hash, so the debug and the normal libraries never mix.  Off by default.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "NVCC_FLAGS", "STAGE1_SOURCES",
           "BOUNDS_ENV", "flags", "build", "load", "build_log", "entry",
           "check", "aligned"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("bacam_decode", "paged_flash_decode", "bacam_topk", "bacam_mvm",
           "bitslice_vmm", "flash_attention", "flash_attention_f32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
STAGE1_SOURCES = ("bacam_decode", "bacam_topk")
BOUNDS_ENV = "REPRO_TORCH_STAGE1_BOUNDS"

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
_LOGS: Dict[str, str] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin/ on PATH); the CUDA kernels cannot be built")


def flags(name: str) -> tuple:
    """The ``nvcc`` flags of ``csrc/<name>.cu``: ``NVCC_FLAGS``, plus the
    bounds check of the stage-1 sources when ``BOUNDS_ENV`` is 1."""
    if name in STAGE1_SOURCES and os.environ.get(BOUNDS_ENV) == "1":
        return NVCC_FLAGS + ("-DBACAM_STAGE1_BOUNDS",)
    return NVCC_FLAGS


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    tag = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no current library, all
    ``nvcc`` processes started together.  Returns {name: seconds} of the
    builds that ran; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took = {}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        _LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) of the build of ``name`` in this process, if one ran."""
    return _LOGS.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return _LIBS[name]


def entry(name: str, symbol: str, n_ptr: int, n_int: int,
          n_float: int = 0):
    """C function ``symbol`` of ``csrc/<name>.cu`` taking ``n_ptr``
    pointers, then ``n_int`` ints, ``n_float`` floats and the stream; it
    returns the launch's ``cudaGetLastError()`` as an int."""
    key = f"{name}.{symbol}"
    if key not in _FNS:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def check(name: str, t: torch.Tensor, device, dtype, shape):
    """Raise unless ``t`` lies on ``device`` with ``dtype`` and ``shape``
    and is contiguous (what a kernel launch assumes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start 16-byte aligned (for the
    kernels that read 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
