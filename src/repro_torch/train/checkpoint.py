"""Checkpointing: async, atomic, keep-N, in the reference's format.

Layout:  <dir>/step_<k>/   one .npy per leaf + manifest.json, leaf keys
joined by ``::`` (``params::blocks::attn::wq``, ``opt::step``) and
``blocks`` stacked along a leading layers axis, as the reference's
``train/checkpoint.py`` writes them: a checkpoint of either package
restores in the other.  Writes go to <dir>/tmp_<k> and are renamed, so
a crash mid-save never corrupts the latest checkpoint; ``latest_step``
only sees complete checkpoints.  ``AsyncCheckpointer`` copies the state
to host arrays on the calling thread and writes them on a worker thread,
so the optimizer may update the state in place right after ``save``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.convert import stack_blocks

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "host_state"]

_SEP = "::"


def host_state(state) -> dict:
    """The state in the checkpoint layout: numpy copies (never views of
    the state's memory), ``blocks`` stacked."""
    return stack_blocks(_copy(state))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def _flat(tree, prefix=()):
    """{"a::b::c": leaf} in sorted key order (``jax.tree`` order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (str(k),)))
        return out
    return {_SEP.join(prefix): tree}


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3):
    """Synchronous atomic save of a port state (tensors, per-layer
    ``blocks`` lists) or of a state already in the checkpoint layout."""
    items = _flat(stack_blocks(state))
    tmp = os.path.join(ckpt_dir, f"tmp_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for key, arr in items.items():
        fname = key.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int):
    steps = sorted(_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return out


def latest_step(ckpt_dir: str):
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, into, step: int | None = None):
    """Copy checkpoint ``step`` (default: the latest) into the state
    ``into`` in place: each leaf keeps its tensor, device and dtype, and
    must have the stored shape (a layer of a ``blocks`` list takes its
    slice of the stacked leaf).  Returns (into, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        files = {m["key"]: m["file"] for m in json.load(f)["leaves"]}
    missing = set(_flat(_shape_tree(into))) - set(files)
    if missing:
        raise KeyError(f"step_{step} lacks leaves {sorted(missing)}")
    # memory-mapped: a layer of a stacked leaf reads only its slice
    _fill(into, lambda key: np.load(os.path.join(d, files[key]),
                                    mmap_mode="r"), ())
    return into, step


def _shape_tree(tree):
    """``into`` with every ``blocks`` list folded to one dict (the keys
    the checkpoint stores)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _shape_tree(tree[0])
    return tree


def _fill(dst, load, prefix, index=None):
    if isinstance(dst, dict):
        for k, v in dst.items():
            _fill(v, load, prefix + (str(k),), index)
        return
    if isinstance(dst, (list, tuple)):
        for i, v in enumerate(dst):
            _fill(v, load, prefix, i)
        return
    key = _SEP.join(prefix)
    arr = load(key)
    if index is not None:
        arr = arr[index]
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                         f"state shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)))


class AsyncCheckpointer:
    """Background-thread checkpointing (overlaps training compute)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self._thread = None
        self.last_error = None

    def save(self, state, step: int):
        self.wait()
        # the host copy on this thread (the state may be updated in place
        # as soon as save returns); IO on the worker
        host = host_state(state)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, host, step, self.keep)
            except Exception as e:  # noqa: BLE001 — surfaced via last_error
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
