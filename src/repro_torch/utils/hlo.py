"""Per-device FLOP, dot-byte and collective-byte counts of one eager call
of a step: the counterpart of the reference's ``utils/hlo.py``.

No HLO is read here: the port has no compiled program to parse.  The
step runs once (on the meta device in the dry run, launch/dryrun.py) under
two dispatch modes, so every count is this process's, per device, as
the reference's post-partitioning HLO shapes are:

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (2 * m * n
    * k a matrix product, the backward pass's included);
  * dot bytes, the operand and result bytes of every matrix product
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``), the reference's count
    of a ``dot``'s operands and result;
  * collectives, counted where they reach the dispatcher: the c10d ops
    ``partitioning``'s collectives and the backends' shard exchanges
    call, and the functional collectives of DTensor redistributions.
    Bytes follow the reference's ring model: ``max(in, out)`` bytes an
    op, an all-reduce twice that.

The reference's ``loop_multipliers`` (a ``while`` body's trip count, for
scanned layers) has no counterpart: the port runs its layers as an
eager Python loop, so every layer's operations are seen, and counted,
once each.  Operations outside matrix products (elementwise work, the
BA-CAM popcount scoring, gathers) are not counted, in either package.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze_step", "StepCounter", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

_DOTS = {"mm", "addmm", "bmm", "baddbmm"}
_SKIP = {"wait_tensor", "barrier", "monitored_barrier_"}


def _kind(name: str):
    """The reference's collective kind of a c10d / functional op name."""
    if name in _SKIP:
        return None
    for key, kind in (("reduce_scatter", "reduce-scatter"),
                      ("allreduce", "all-reduce"),
                      ("all_reduce", "all-reduce"),
                      ("allgather", "all-gather"),
                      ("all_gather", "all-gather"),
                      ("alltoall", "all-to-all"),
                      ("all_to_all", "all-to-all"),
                      ("broadcast", "broadcast"),
                      ("send", "collective-permute"),
                      ("recv", "collective-permute")):
        if key in name:
            return kind
    return None


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(v) for v in x)
    return 0


class StepCounter(TorchDispatchMode):
    """Counts matrix-product bytes and collectives as they dispatch."""

    def __init__(self):
        super().__init__()
        self.dot_bytes = 0.0
        self.collectives = defaultdict(lambda: {"count": 0.0, "bytes": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in _DOTS:
            ops = args[1:3] if name in ("addmm", "baddbmm") else args[:2]
            self.dot_bytes += _bytes(ops) + _bytes(out)
        elif func.namespace in ("c10d", "_c10d_functional",
                                "_c10d_functional_autograd", "_dtensor"):
            kind = _kind(name)
            if kind is not None:
                moved = max([_bytes(a) for a in args] + [_bytes(out)])
                rec = self.collectives[kind]
                rec["count"] += 1
                rec["bytes"] += moved * (2.0 if kind == "all-reduce"
                                         else 1.0)
        return out


def analyze_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counters; returns
    (its value, stats) with the keys of the reference's ``analyze_hlo``
    that hold their meaning here: ``flops`` and ``dot_bytes`` (per
    device), ``collectives`` ({kind: {"count", "bytes"}}) and
    ``collective_bytes`` (their sum)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = StepCounter()
    with FlopCounterMode(display=False) as flops, counter:
        value = fn(*args, **kwargs)
    coll = {k: dict(v) for k, v in counter.collectives.items()}
    return value, {
        "flops": float(flops.get_total_flops()),
        "dot_bytes": counter.dot_bytes,
        "collectives": coll,
        "collective_bytes": sum(v["bytes"] for v in coll.values()),
    }
