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

A sharded state (DTensor leaves, ``launch/steps.init_state(...,
mesh=)``) is saved as whole arrays: every process takes part in
gathering each leaf, process 0 alone writes, and every process then
passes a barrier, so the files are the same as an unsharded save's.
Restoring into a sharded state copies each process's block of the
stored arrays into its leaves (``local_block``), on whatever mesh: the
elastic restore of launch/elastic.py.
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
           "AsyncCheckpointer", "host_state", "local_block"]

_SEP = "::"


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _is_sharded(tree) -> bool:
    """True when a leaf of ``tree`` is a DTensor (a sharded state)."""
    if isinstance(tree, dict):
        return any(_is_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_is_sharded(v) for v in tree)
    return torch.is_tensor(tree) and isinstance(tree, _dtensor())


def _writer() -> bool:
    """Whether this process writes: process 0 of an initialised group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def local_block(full, mesh, placements):
    """This process's block of the whole array ``full`` (a tensor or a
    numpy array) under DTensor ``placements`` on ``mesh``: DTensor's own
    offsets, so the block is the one ``full_tensor`` puts back there."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        tuple(full.shape), mesh, placements)
    return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def host_state(state) -> dict:
    """The state in the checkpoint layout: numpy copies (never views of
    the state's memory), ``blocks`` stacked.  DTensor leaves are gathered
    (every process of their mesh must call this)."""
    return stack_blocks(_copy(state))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    if torch.is_tensor(tree):
        if isinstance(tree, _dtensor()):  # a replicated one is its local
            return tree.full_tensor().to("cpu", copy=True)
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
    ``blocks`` lists) or of a state already in the checkpoint layout.  A
    sharded state is gathered by every process and written by process
    0; all pass a barrier after the write."""
    if _is_sharded(state):
        host = host_state(state)
        final = _write(ckpt_dir, host, step, keep) if _writer() else None
        _barrier()
        return final
    return _write(ckpt_dir, state, step, keep)


def _write(ckpt_dir, state, step, keep):
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


def restore_checkpoint(ckpt_dir: str, into, step: int | None = None, *,
                       mesh=None):
    """Copy checkpoint ``step`` (default: the latest) into the state
    ``into`` in place: each leaf keeps its tensor, device and dtype, and
    must have the stored shape (a layer of a ``blocks`` list takes its
    slice of the stacked leaf).  A DTensor leaf (a state sharded on
    ``mesh``, which its leaves must live on when given) takes this
    process's block of the stored array.  Returns (into, step)."""
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
                                    mmap_mode="r"), (), mesh=mesh)
    return into, step


def _shape_tree(tree):
    """``into`` with every ``blocks`` list folded to one dict (the keys
    the checkpoint stores)."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _shape_tree(tree[0])
    return tree


def _fill(dst, load, prefix, index=None, mesh=None):
    if isinstance(dst, dict):
        for k, v in dst.items():
            _fill(v, load, prefix + (str(k),), index, mesh)
        return
    if isinstance(dst, (list, tuple)):
        for i, v in enumerate(dst):
            _fill(v, load, prefix, i, mesh)
        return
    key = _SEP.join(prefix)
    arr = load(key)
    if index is not None:
        arr = arr[index]
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                         f"state shape {tuple(dst.shape)}")
    if isinstance(dst, _dtensor()):
        if mesh is not None and dst.device_mesh != mesh:
            raise ValueError(f"{key}: the state lives on another mesh")
        arr = local_block(arr, dst.device_mesh, dst.placements)
        dst = dst.to_local()
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(arr)))


class AsyncCheckpointer:
    """Background-thread checkpointing (overlaps training compute)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir, self.keep = ckpt_dir, keep
        self._thread = None
        self._sharded = False  # a sharded save's barrier is pending
        self.last_error = None

    def save(self, state, step: int):
        """Every process of a sharded state calls this: the gather is
        collective; process 0 alone writes, and ``wait`` (every process)
        passes a barrier after the write."""
        self.wait()
        # the host copy on this thread (the state may be updated in place
        # as soon as save returns); IO on the worker
        host = host_state(state)
        self._sharded = _is_sharded(state)
        if not _writer():
            return

        def work():
            try:
                _write(self.ckpt_dir, host, step, self.keep)
            except Exception as e:  # noqa: BLE001 — surfaced via last_error
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            _barrier()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
