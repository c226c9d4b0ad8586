"""Synthetic LM data stream, deterministic and restart-safe.

Token (step, row, col) is a pure function of (seed, step, row): a restart
at step k reproduces the exact stream, and the token, label and mask
batches are the reference's (``train/data.py``) bit for bit for the same
seed and step.  A background thread can prefetch batches ahead of the
consumer.  Under a mesh each process builds only its rows of the same
global batch: the block of rows ``ACT_RULES["batch"]`` gives it (the
rows split over ``row_axes``), as the reference's per-shard callbacks
build theirs; the modality stubs are drawn whole and sliced, so the
global batch is the same on any mesh.

The stream is a Zipf-ish unigram mix with a repeated motif per row, so a
language model has signal to fit and its loss falls.

Modality stubs (VLM patch embeddings, audio frame embeddings) are seeded
with ``zlib.crc32`` of the input's name.  The reference seeds them with
``hash(name)``, which Python randomises per process for a ``str``, so its
stubs differ between two processes with the same seed; the port's are
the same in every process, and therefore differ from the reference's.
"""

from __future__ import annotations

import queue
import threading
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.inputs import input_specs

__all__ = ["SyntheticLMData", "make_batch_arrays"]


def _row_tokens(seed: int, step: int, row: int, length: int, vocab: int):
    rng = np.random.Generator(np.random.Philox(
        key=[(seed << 32) + step, row]))
    # Zipf-ish unigram distribution over an active sub-vocab
    active = max(64, min(vocab, 4096))
    base = rng.zipf(1.3, size=length + 9) % active
    # repeated motif: every row embeds a periodic k-gram (learnable signal)
    motif = rng.integers(0, active, size=8)
    period = 16 + (row % 7)
    idx = np.arange(length + 9)
    base[idx % period < 8] = motif[(idx % period)[idx % period < 8]]
    return np.asarray(base[:length] % vocab, np.int32)


def _stub_key(name: str) -> int:
    """A per-input seed word that is the same in every process."""
    return zlib.crc32(name.encode()) % (2**31)


class SyntheticLMData:
    """Train batches of one (cfg, shape) on ``device``."""

    def __init__(self, cfg, shape_name: str, seed: int = 0, device="cuda",
                 prefetch: int = 2, *, mesh=None):
        self.cfg, self.seed = cfg, seed
        self.device = resolve_device(device)
        self.specs = input_specs(cfg, shape_name)
        b = self.specs["tokens"][0][0]
        self.rows, self.row_axes = range(b), ()
        if mesh is not None:
            from repro_torch.launch.steps import batch_row_axes
            from repro_torch.sharding.partitioning import axis_sizes

            self.row_axes = batch_row_axes(mesh, b)
            sizes = axis_sizes(mesh)
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            blk, n = 0, 1
            for a in self.row_axes:  # major-to-minor, the reference's order
                blk, n = blk * sizes[a] + coord[a], n * sizes[a]
            per = b // n
            self.rows = range(blk * per, (blk + 1) * per)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread = None
        self._stop = threading.Event()

    def batch(self, step: int) -> dict:
        """The batch of ``step`` (a pure function of seed and step): this
        process's rows of it under a mesh."""
        s = self.specs["tokens"][0][1]
        r0, r1 = self.rows.start, self.rows.stop
        rows = np.stack([_row_tokens(self.seed, step, r, s + 1,
                                     self.cfg.vocab) for r in self.rows])
        out = {}
        for key, (shape, dtype) in self.specs.items():
            if key == "tokens":
                arr = torch.from_numpy(rows[:, :s].copy())
            elif key == "labels":
                arr = torch.from_numpy(rows[:, 1:].copy())
            elif key == "loss_mask":
                arr = torch.ones((r1 - r0,) + tuple(shape[1:]), dtype=dtype)
            else:  # modality stubs: deterministic pseudo-embeddings
                r = np.random.Generator(np.random.Philox(
                    key=[(self.seed << 32) + step, _stub_key(key)]))
                arr = torch.from_numpy(
                    r.standard_normal(shape)[r0:r1].copy()).to(dtype)
            out[key] = arr.to(self.device)
        return out

    # --- prefetch ------------------------------------------------------
    def start(self, first_step: int):
        def worker():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def make_batch_arrays(cfg, shape_name, step=0, seed=0, device="cuda"):
    """One-shot convenience (tests / examples): the batch of ``step``,
    ``SyntheticLMData(cfg, shape_name, seed, device).batch(step)``.  The
    reference's takes a mesh where this takes a device."""
    return SyntheticLMData(cfg, shape_name, seed, device).batch(step)
