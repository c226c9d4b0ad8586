"""Tensor-parallel serving: head-sharded page pools, and one tick plan on
every process.

Partition the memory, not the compute (the reference's
``serving/sharded.py``).  CAMformer's BA-CAM banks are physically
partitioned associative memories searched in parallel; the serving
analog gives each of ``tp`` processes (one a device, ``torch.distributed``)
a kv-head slice of EVERY page and lets it score that slice locally:

  * every page-pool leaf whose logical axes name ``"kv_heads"`` (dense
    ``k_pages``/``v_pages``, binary/camformer ``kp_pages``/``k_scale``/
    ``k_means``) holds ``n_kv_heads / tp`` heads on each process:
    :func:`pool_partition_specs` derives the spec of each leaf from its
    logical axes (:data:`PAGE_AXES`), and :func:`init_local_pools`
    allocates this process's slice;
  * each process runs its own host ``Scheduler`` over its own copy of
    the ONE page table.  The reference plans once for a ``shard_map``
    step that cannot diverge; here the processes must plan the same
    tick, or one of them waits forever in the head gather.  So every
    host input that can differ between processes — submissions and
    cancellations, the clock reading that decides deadlines, the fault
    plan's delay draw — is taken on rank 0 and broadcast with the tick
    over a gloo side group (NCCL never carries Python objects), every
    process compares a digest of its ``TickPlan`` with the others', and
    a failed tick is agreed before containment (:class:`TickSync`);
  * inside the device step each process slices q/k/v to its heads, runs
    the backend's paged write and attention on its pool slice, and the
    per-head outputs are concatenated along heads in rank order by an
    all-gather (models/attention.py ``tp_local_decode`` / ``tp_gather``);
    the rest of the forward, and the keyed sampling, run replicated.

Why an all-gather of per-head attention outputs instead of a sum of
partial ``wo`` products: attention heads are independent, so gathering
the per-process head slices is pure concatenation (no arithmetic), and
every process reconstructs bit-identical full-head activations, then
identical logits and identical keyed samples: the tp > 1 token streams
are the single-device engine's bit for bit.  A sum of per-shard partial
``wo`` products would change the floating-point summation order and
break token-for-token identity.

COW prefix forks and ``truncate_to`` rollback need no new code: a fork
copies pages along the PAGE axis (never the head axis), so the engine's
``_copy_pool_page`` runs unchanged on the local slices, and rollback is
host page-table arithmetic.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["HEAD_AXIS", "TP_AXIS", "PAGE_AXES", "leaf_partition_spec",
           "pool_partition_specs", "local_page_specs", "init_local_pools",
           "head_range", "slice_pools", "pool_bytes", "plan_digest",
           "PlanMismatchError", "TickFailedElsewhere", "TickSync"]

HEAD_AXIS = "kv_heads"  # the logical axis every page pool shards over
TP_AXIS = "tp"  # the mesh axis name (launch/mesh.py make_tp_mesh)

# logical axes of each page-pool leaf (the reference's ``page_spec``
# axes; the port's ``page_spec`` gives (shape, dtype) only)
PAGE_AXES = {
    "k_pages": (None, "kv_heads", None, "head_dim"),
    "v_pages": (None, "kv_heads", None, "head_dim"),
    "kp_pages": (None, "kv_heads", None, None),
    "k_scale": ("batch", "kv_heads"),
    "k_means": ("batch", "kv_heads", None),
}


def leaf_partition_spec(axes: Sequence[Optional[str]]) -> tuple:
    """The spec of one pool leaf: ``"tp"`` on the kv-head axis, every
    other dimension replicated."""
    return tuple(TP_AXIS if a == HEAD_AXIS else None for a in axes)


def _leaf_spec(name: str, shape, axes, tp: int) -> tuple:
    if HEAD_AXIS not in axes:
        return ()
    dim = axes.index(HEAD_AXIS)
    if shape[dim] % tp != 0:
        raise ValueError(
            f"page_spec leaf {name!r}: kv-head axis has extent "
            f"{shape[dim]} (axis {dim} of shape {tuple(shape)}), which "
            f"does not divide over tp={tp}; pick a tp degree that divides "
            "n_kv_heads")
    return leaf_partition_spec(axes)


def _uniform(specs) -> bool:
    first = specs[0]
    return all(set(s) == set(first)
               and all(tuple(s[k][0]) == tuple(first[k][0]) for k in s)
               for s in specs)


def pool_partition_specs(specs, tp: int) -> list:
    """The spec tree of a page-pool tree: one spec a leaf, ``"tp"`` on its
    kv-head axis.

    ``specs`` is ``md.page_specs(...)``: a list of per-layer {leaf:
    (shape, dtype)}.  The result has its structure.  Each entry is the
    reference's for that leaf without the leading ``layers`` entry its
    uniform stacks carry (the port keeps a list of per-layer pools for
    every stack).  Raises ``ValueError`` naming the leaf (``layer<i>.``
    before it in a mixed stack, as the reference names them) when a
    kv-head axis does not divide by ``tp``.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    uniform = _uniform(specs)
    return [{name: _leaf_spec(name if uniform else f"layer{i}.{name}",
                              shape, PAGE_AXES[name], tp)
             for name, (shape, _) in layer.items()}
            for i, layer in enumerate(specs)]


def local_page_specs(specs, tp: int) -> list:
    """``specs`` with every kv-head axis cut to ``1 / tp`` (validated by
    ``pool_partition_specs`` first)."""
    pspecs = pool_partition_specs(specs, tp)

    def local(shape, spec):
        return tuple(n // tp if e == TP_AXIS else n
                     for n, e in zip(shape, spec + (None,) * len(shape)))

    return [{name: (local(shape, pspecs[i][name]), dt)
             for name, (shape, dt) in layer.items()}
            for i, layer in enumerate(specs)]


def init_local_pools(specs, tp: int, device) -> list:
    """This process's zero-filled pools: every page at ``n_kv_heads / tp``
    heads."""
    from repro_torch.models.transformer import init_pools

    return init_pools(local_page_specs(specs, tp), device)


def head_range(rank: int, tp: int, cfg) -> tuple:
    """(kv-head slice, q-head slice) of process ``rank`` of ``tp``: kv
    heads ``[i*hl, (i+1)*hl)`` and their q heads ``[i*g*hl,
    (i+1)*g*hl)`` (q heads are grouped per kv head)."""
    hl = cfg.n_kv_heads // tp
    g = cfg.n_heads // cfg.n_kv_heads
    return (slice(rank * hl, (rank + 1) * hl),
            slice(rank * g * hl, (rank + 1) * g * hl))


def slice_pools(pools, rank: int, tp: int) -> list:
    """The kv-head slice of process ``rank`` of every leaf of a whole
    (tp = 1) pool tree, as contiguous copies."""
    def one(name, t):
        dim = PAGE_AXES[name].index(HEAD_AXIS)
        hl = t.shape[dim] // tp
        return t.narrow(dim, rank * hl, hl).clone(
            memory_format=torch.contiguous_format)

    return [{name: one(name, t) for name, t in layer.items()}
            for layer in pools]


def pool_bytes(pools) -> int:
    """Bytes held by a pool tree."""
    return sum(t.numel() * t.element_size()
               for layer in pools for t in layer.values())


# ---------------------------------------------------------------------------
# one plan on every process


class PlanMismatchError(RuntimeError):
    """The processes of a tensor-parallel engine planned different ticks
    (their ``TickPlan`` digests differ)."""


class TickFailedElsewhere(RuntimeError):
    """Another process of the tensor-parallel engine failed this tick."""


def plan_digest(plan) -> int:
    """A 63-bit digest of a ``TickPlan``: its forks, every host array and
    each emit's (slot, rid, index)."""
    h = hashlib.blake2b(digest_size=8)

    def feed(x):
        if x is None:
            h.update(b"-")
        elif isinstance(x, np.ndarray):
            h.update(str((x.dtype, x.shape)).encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, tuple) and x and hasattr(x[0], "req"):  # emits
            h.update(repr([(e.slot, e.req.rid, e.index) for e in x])
                     .encode())
        elif isinstance(x, tuple) and hasattr(x, "_fields"):  # a chunk
            for v in x:
                feed(v)
        else:
            h.update(repr(x).encode())

    feed(plan)
    return int.from_bytes(h.digest(), "little") >> 1


class TickInputs(NamedTuple):
    """What rank 0 sends with each tick: the call the followers make, the
    control operations since the last tick, the clock reading and the
    fault plan's delay draw."""

    call: str  # "poll", "step", "prefill" or "stop"
    ops: tuple  # ("submit", prompt, sampling, rid, priority, t) | ("cancel", rid)
    clock: float
    delay: float


class TickSync:
    """The host side of one tensor-parallel engine's processes: rank 0
    leads (it takes the submissions, cancellations, clock and fault
    draws and broadcasts them with each tick), the others follow.

    Every collective runs over a gloo side group of the tp mesh's
    processes, in the same order on every process."""

    def __init__(self, mesh):
        import torch.distributed as dist

        from repro_torch.launch.mesh import tp_control_group

        self.rank = mesh.get_local_rank(TP_AXIS)
        self.size = mesh.size()
        self.src = 0  # global rank of the leader: the world's first
        self.group = tp_control_group(self.size)
        self.leader = self.rank == 0
        self.ops: list = []  # the leader's control operations since a tick
        self.checks = 0  # plans compared
        self._dist = dist

    def _broadcast(self, obj):
        box = [obj]
        self._dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def send(self, call: str, clock: float = 0.0,
             delay: float = 0.0) -> None:
        """Rank 0: broadcast the tick's inputs (and clear the ops)."""
        msg = TickInputs(call, tuple(self.ops), clock, delay)
        self.ops = []
        self._broadcast(msg)

    def receive(self) -> TickInputs:
        """A follower: the next tick's inputs from rank 0."""
        return self._broadcast(None)

    def _gather(self, values) -> torch.Tensor:
        mine = torch.tensor([values], dtype=torch.int64)
        out = torch.empty((self.size, len(values)), dtype=torch.int64)
        self._dist.all_gather_into_tensor(out, mine, group=self.group)
        return out

    def check_plan(self, plan) -> None:
        """Compare this tick's plan digest with every process's; a
        mismatch raises ``PlanMismatchError`` on every process."""
        got = self._gather([plan_digest(plan)])[:, 0]
        self.checks += 1
        if bool((got != got[0]).any()):
            raise PlanMismatchError(
                f"tensor-parallel processes planned different ticks "
                f"(digests by rank: {got.tolist()})")

    def agree(self, err: Optional[BaseException]):
        """The tick's outcome agreed across processes: ``err`` when this
        process failed, a ``TickFailedElsewhere`` when only others did,
        else None."""
        failed = self._gather([int(err is not None)])[:, 0]
        if err is not None or not bool(failed.any()):
            return err
        ranks = [i for i, f in enumerate(failed.tolist()) if f]
        return TickFailedElsewhere(
            f"the tick failed on tp rank(s) {ranks}")

    def check_params(self, params) -> None:
        """Every process serves the same weights: each leaf's bytes
        hashed, rank 0's hash broadcast and compared on every process."""
        from repro_torch.models.module import tree_leaves

        h = hashlib.blake2b(digest_size=16)
        for t in tree_leaves(params):
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        want = self._broadcast(h.hexdigest())
        same = self._gather([int(want == h.hexdigest())])[:, 0]
        if not bool(same.all()):
            raise ValueError(
                "tensor-parallel processes hold different parameters "
                f"(same as rank 0's, by rank: {same.tolist()})")
