"""Logical-axis sharding rules with divisibility-checked fallback chains
(the reference's ``sharding/partitioning.py``), for ``torch.distributed``.

Every parameter, activation and cache tensor carries logical axis names
(``models/module.param_axes``, ``launch/inputs.batch_axes``,
``launch/steps.cache_axes``).  A rule maps a logical axis to an ordered
list of mesh-axis candidates (each a mesh-axis name or a tuple of them).
Resolution walks the tensor's dimensions in order and gives each the
first candidate whose mesh size divides it and whose mesh axes are still
free, so e.g. GQA KV caches with 8 heads on a 16-way ``model`` axis fall
through to sequence (context) parallelism.

``resolve_spec`` returns a spec: a tuple with one entry per dimension,
``None``, a mesh-axis name or a tuple of names, the entries of the
reference's ``PartitionSpec``.  It reads only the mesh's axis sizes, so
a shape-only mesh (``launch/mesh.MeshShape``) resolves the production
meshes without 256 processes.  ``placements`` turns a spec into the
DTensor placements of a live ``DeviceMesh``: a tuple entry is
``Shard(d)`` on each of its mesh dims in the tuple's order, which splits
the dimension major-to-minor in that order, the reference's block order.

``sharded_batch`` marks the code inside it as running on this process's
rows of a batch sharded over some mesh axes; ``batch_sum`` then sums a
statistic over those axes (the loss's token count, the MoE routing
sums), so that the loss is the global batch's and not a per-rank one.

``model_split`` marks the code inside it as running this process's share
of a compute split over the mesh's ``model`` axis (the reference's GSPMD
split under the ``tp`` profile, Megatron style): the model code receives
this process's blocks of the parameters the train step kept split (its
heads, MLP columns, vocabulary rows, experts, RG-LRU channels, RWKV-6
heads) and brackets each split
region with ``enter_split`` (identity forward, the input gradient summed
over ``model`` backward) and ``exit_split`` (the partial outputs summed
over ``model`` forward, identity backward).  At a ``model`` of 1 both
are the identity.

The residual stream's sequence split (``res_seq``, Megatron sequence
parallelism) adds four sequence collectives over ``model``, two inverse
pairs: a split region holding this process's rows of the stream enters
through ``gather_seq`` (all-gather forward, reduce-scatter backward) and
leaves through ``scatter_seq`` (reduce-scatter forward, all-gather
backward); a replicated consumer takes the whole sequence through
``whole_seq`` (all-gather forward, this process's rows of the gradient
backward) and a replicated producer hands the stream its rows through
``local_seq`` (this process's rows forward, all-gather backward).
``region_in`` / ``region_out`` pick the entry and exit of a region from
whether it is split and whether the stream is.  ``reduce_scatter``
keeps this process's block of the sum along any dimension (the RG-LRU
gates, models/rglru.py).

Share mode (``run_shares``) runs every rank's share of the split code in
one process, without a process group: one thread a rank, taking turns,
so exactly one runs at a time.  At each collective every rank hands in
its local tensor and the last combines them (the partial outputs
summed, the rows concatenated) as plain autograd operations, so one
backward pass from the result (the caller sums through them) gives each
rank's parameter block its gradient and sums a parameter used whole
over the ranks, as the train step's reductions do.  It needs no card
count and no NCCL, so the card checks every degree's shares against the
unsplit code in one process (``chip_smoke.py`` phase 14).  A share's
state is its thread's: no block is recomputed inside share mode
(``models/transformer.run_block``).

The sharded serving steps (``launch/steps.make_prefill_step`` /
``make_serve_step`` with a mesh) run inside ``model_split`` too, under
``torch.no_grad``: the collectives then record no autograd state.  Two
things are theirs alone.  ``q_seq_here`` says whether a prompt chunk's
attention splits its query rows over ``model`` (the reference's
``q_seq``, for heads that do not divide): the region enters through
``local_seq`` (this process's Sq / m rows) and leaves through
``whole_seq`` (the rows all-gathered).  ``cache_seq_split`` marks the
contiguous attention caches inside as this process's block of the
sequence (``CACHE_RULES["kv_seq"]``, over whatever mesh axes the batch
and the heads left): ``cache_seq`` gives the block's shard index, the
number of shards and a ``SeqComm`` whose ``gather`` / ``sum`` / ``max``
combine the shards' tensors (core/backend.py merges the shards'
attention with them).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

import torch

__all__ = [
    "PARAM_RULES", "SERVE_PARAM_RULES", "ACT_RULES", "CACHE_RULES",
    "resolve_spec", "tree_pspecs", "placements", "constrain",
    "set_parallelism_profile", "get_parallelism_profile", "axis_sizes",
    "sharded_batch", "batch_sum", "in_sharded_batch", "model_split",
    "split_rank", "split_here", "note_split", "enter_split", "exit_split",
    "model_max", "SPLIT_SEEN", "gather_seq", "scatter_seq", "whole_seq",
    "local_seq", "reduce_scatter", "region_in", "region_out",
    "seq_split_here", "run_shares", "in_shares", "local_part",
    "q_seq_here", "cache_seq_split", "cache_seq", "SeqComm",
    "cache_seq_over_model", "gather_split",
]

# Candidates may reference axes absent from the current mesh ("pod" on the
# single-pod mesh); absent axes are skipped.
PARAM_RULES = {
    "embed": [("pod", "data"), ("data",)],  # FSDP (ZeRO-3 style)
    "mlp": [("model",)],
    "heads": [("model",)],  # fused n_heads*head_dim projection dim
    "kv_heads": [("model",)],  # fused n_kv*head_dim (divisible even when
    #                            the raw head count is not)
    "vocab": [("model",)],
    "experts": [("model",)],
    "expert_mlp": [("model",)],
    "rnn": [("model",)],
    "layers": [],  # the reference's scan axis: never sharded
    "conv": [],
    "head_dim": [],
}

# Serving weights: TP over `model` only, replicated across data.
SERVE_PARAM_RULES = {
    **{k: v for k, v in PARAM_RULES.items()},
    "embed": [],
}

ACT_RULES = {
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "seq": [],  # sequence kept unsharded in-layer for train/prefill
    "res_seq": [("model",)],  # residual-stream sequence (Megatron SP)
    "att_q_seq": [("model",)],  # attention query sequence, heads failing
    "embed": [],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "mlp": [("model",)],
    "vocab": [("model",)],
    "experts": [("model",)],
    "capacity": [("model",)],
    "expert_mlp": [("model",)],
    "rnn": [("model",)],
    "head_dim": [],
}

# KV caches / recurrent states: when batch or heads cannot take the mesh
# axes, the cache sequence dim picks them up => context parallelism.
CACHE_RULES = {
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "kv_heads": [("model",)],
    "heads": [("model",)],
    "kv_seq": [("pod", "data", "model"), ("data", "model"), ("pod", "data"),
               ("data",), ("model",)],
    "head_dim": [],
    "embed": [],
    "rnn": [("model",)],
    "conv": [],
}


_PROFILE = "tp"


def set_parallelism_profile(name: str):
    """Switch the global sharding profile (module globals, as the
    reference's).

    tp (default): parameters FSDP over ``data`` and split over ``model``,
        the batch over (``pod``, ``data``).
    dp: the batch and the FSDP ``embed`` axis over every axis
        ((``pod``, ``data``, ``model``)); the resolver then leaves the
        ``model``-axis rules nothing to take.
    """
    global _PROFILE
    if name not in ("tp", "dp"):
        raise ValueError(name)
    _PROFILE = name
    all_axes = [("pod", "data", "model"), ("data", "model")]
    if name == "dp":
        PARAM_RULES["embed"] = list(all_axes) + [("data",)]
        ACT_RULES["batch"] = list(all_axes) + [("data",), ("model",)]
        CACHE_RULES["batch"] = list(all_axes) + [("data",), ("model",)]
    else:
        PARAM_RULES["embed"] = [("pod", "data"), ("data",)]
        ACT_RULES["batch"] = [("pod", "data"), ("data",), ("pod",)]
        CACHE_RULES["batch"] = [("pod", "data"), ("data",), ("pod",)]


def get_parallelism_profile() -> str:
    return _PROFILE


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a live ``DeviceMesh`` or of any object whose
    ``shape`` is such a mapping (``launch/mesh.MeshShape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def resolve_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh, rules: dict) -> tuple:
    """Resolve logical axes -> spec under divisibility fallback."""
    sizes = axis_sizes(mesh)
    taken: set = set()
    entries = []
    for name, dim in zip(logical_axes, shape):
        assigned = None
        for cand in rules.get(name, ()) if name else ():
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            # drop absent axes from the candidate rather than skipping it
            cand_t = tuple(a for a in cand_t if a in sizes)
            if not cand_t or any(a in taken for a in cand_t):
                continue
            size = math.prod(sizes[a] for a in cand_t)
            if size and dim % size == 0 and dim > 0:
                assigned = cand_t
                taken.update(cand_t)
                break
        if assigned is None:
            entries.append(None)
        elif len(assigned) == 1:
            entries.append(assigned[0])
        else:
            entries.append(assigned)
    return tuple(entries)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_pspecs(axes_tree, shapes_tree, mesh, rules: dict):
    """Zip an axes tree (tuple leaves) with a shapes tree (shape tuples,
    or objects with a ``shape``) into a tree of specs."""
    if isinstance(axes_tree, dict):
        return {k: tree_pspecs(axes_tree[k], shapes_tree[k], mesh, rules)
                for k in axes_tree}
    if isinstance(axes_tree, list):
        return [tree_pspecs(a, s, mesh, rules)
                for a, s in zip(axes_tree, shapes_tree)]
    assert _is_axes(axes_tree), axes_tree
    shape = getattr(shapes_tree, "shape", shapes_tree)
    return resolve_spec(axes_tree, tuple(shape), mesh, rules)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the live ``DeviceMesh``
    ``mesh``: ``Shard(d)`` on the mesh dims that dimension d's entry
    names, ``Replicate()`` on the others.  A tuple entry must name its
    axes in mesh order (every rule's candidates do): DTensor splits a
    dimension sharded on several mesh dims major-to-minor in mesh
    order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: dict = ACT_RULES) -> torch.Tensor:
    """The identity.  The reference's ``with_sharding_constraint`` hints
    GSPMD where to place an activation inside one traced program; the port
    computes eagerly on each process's local tensors, and a tensor's
    placement is whatever the code that made it chose (the train step
    gathers parameters and splits rows explicitly), so there is nothing
    to constrain."""
    del logical_axes, rules
    return x


# --- the batch this process holds rows of --------------------------------

_BATCH = None  # (mesh, axes) inside ``sharded_batch``


@contextlib.contextmanager
def sharded_batch(mesh, axes: Sequence[str]):
    """Code inside runs on this process's rows of a batch sharded over the
    mesh axes ``axes`` (none: every process holds the whole batch)."""
    global _BATCH
    prev, _BATCH = _BATCH, (mesh, tuple(axes)) if axes else None
    try:
        yield
    finally:
        _BATCH = prev


def in_sharded_batch() -> bool:
    """True inside ``sharded_batch`` over at least one mesh axis."""
    return _BATCH is not None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the processes that hold the other rows of the
    batch (a detached copy, all-reduced over each batch axis); ``t``
    itself outside ``sharded_batch``."""
    if _BATCH is None:
        return t
    import torch.distributed as dist

    mesh, axes = _BATCH
    out = t.detach().clone()
    for a in axes:
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


# --- the compute split over ``model`` ----------------------------------

_MODEL = None  # (group, rank, size) inside ``model_split``
_TLS = threading.local()  # a share's (shares, rank, size) in run_shares

# what the split code last ran on, by region (the local heads, MLP
# columns, vocabulary rows and experts): a record for tests and probes
SPLIT_SEEN: dict = {}


def _state():
    """(group, rank, size) of the split here: this thread's share inside
    ``run_shares``, else ``model_split``'s (None outside both)."""
    share = getattr(_TLS, "model", None)
    return _MODEL if share is None else share


@contextlib.contextmanager
def model_split(mesh, axis: str = "model"):
    """Code inside runs this process's share of the compute split over
    the mesh axis ``axis`` (see the module doc)."""
    global _MODEL
    size = axis_sizes(mesh)[axis]
    group = mesh.get_group(axis) if size > 1 else None
    prev, _MODEL = _MODEL, (group, mesh.get_local_rank(axis), size)
    try:
        yield
    finally:
        _MODEL = prev


def split_rank() -> Optional[tuple]:
    """(rank, size) along the split axis inside ``model_split`` or a
    share of ``run_shares``, else None."""
    st = _state()
    return None if st is None else st[1:]


def split_here(local: int, whole: int) -> bool:
    """Whether a region whose parameter extent is ``local`` here and
    ``whole`` in full runs split: inside ``model_split`` when the train
    step kept the block split (``local < whole``), or at a split of size
    1, where the split code runs on whole blocks with identity
    collectives.  A block gathered whole (the resolver left the dim
    unsharded) runs whole."""
    st = _state()
    if st is None:
        return False
    return st[2] == 1 or local < whole


def seq_split_here(length: int) -> bool:
    """Whether the residual stream of a sequence of ``length`` splits
    its rows over the split axis (``res_seq``): inside the split when
    the axis divides it (the resolver's fallback keeps whole rows), and
    at a split of size 1, where the sequence collectives are the
    identity."""
    st = _state()
    return st is not None and (st[2] == 1 or length % st[2] == 0)


def in_shares() -> bool:
    """True in a share of ``run_shares``."""
    return getattr(_TLS, "model", None) is not None


def note_split(region: str, n: int) -> None:
    """Record that ``region`` ran on ``n`` local units (``SPLIT_SEEN``)."""
    SPLIT_SEEN[region] = n


class _Shares:
    """The ranks of ``run_shares``: one thread each, taking turns (the
    turn passes at each collective and at the end), so one rank runs at
    a time, in rank order."""

    def __init__(self, size: int):
        self.size, self.turn, self.error = size, 0, None
        self.parts, self.out, self.rounds = [None] * size, None, [0] * size
        self.cond = threading.Condition()

    def _wait(self, rank):
        self.cond.wait_for(lambda: self.turn == rank
                           or self.error is not None)
        if self.error is not None:
            raise RuntimeError("another share failed") from self.error

    def _pass(self, rank):
        self.turn = (rank + 1) % self.size
        self.cond.notify_all()

    def exchange(self, rank: int, x: torch.Tensor, combine):
        """Hand in this rank's ``x``; every rank gets ``combine`` of the
        ranks' tensors in rank order (computed once, by the last)."""
        with self.cond:
            self.parts[rank] = x
            self.rounds[rank] += 1
            if rank == self.size - 1:
                if any(t is None for t in self.parts):
                    raise RuntimeError("the shares ran different "
                                       "collectives")
                self.out, self.parts = combine(self.parts), [None] * self.size
            self._pass(rank)
            self._wait(rank)
            return self.out

    def run(self, fn) -> list:
        grad = torch.is_grad_enabled()
        results = [None] * self.size

        def body(rank):
            _TLS.model = (self, rank, self.size)
            try:
                with torch.set_grad_enabled(grad):
                    with self.cond:
                        self._wait(rank)
                    results[rank] = fn(rank)
                with self.cond:
                    self._pass(rank)
            except BaseException as e:  # stop the other shares too
                with self.cond:
                    if self.error is None:
                        self.error = e
                    self.cond.notify_all()
            finally:
                _TLS.model = None

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self.error is not None:
            raise self.error
        if len(set(self.rounds)) != 1:
            raise RuntimeError(f"the shares ran different numbers of "
                               f"collectives: {self.rounds}")
        return results


def run_shares(fn, size: int) -> list:
    """``[fn(0), ..., fn(size - 1)]``: each rank's share of the split code
    in turn in this process (share mode, see the module doc).  ``fn(r)``
    runs as rank ``r`` of ``size``: it passes the model code rank r's
    blocks of the split parameters (``launch/steps.share_params``) and
    its rows of a split stream, and the code's collectives exchange the
    ranks' tensors in process."""
    return _Shares(size).run(fn)


def _narrow(x, dim, rank, size):
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


def _comm(x, kind, dim, st):
    """One collective over the split axis of ``st`` (along ``dim``)
    between processes: ``identity``, ``all_reduce``, ``gather`` (an
    all-gather), ``reduce_scatter`` (this rank's block of the sum) or
    ``slice`` (this rank's block, no communication)."""
    group, rank, size = st
    if kind == "identity":
        return x.view_as(x)
    if kind == "slice":
        return _narrow(x, dim, rank, size)
    import torch.distributed as dist

    xt = x.movedim(dim, 0).contiguous()
    if kind == "gather":
        out = torch.empty((size * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=xt.dtype, device=xt.device)
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)
    if kind == "reduce_scatter" and dist.get_backend(group) == "nccl":
        out = torch.empty((xt.shape[0] // size,) + tuple(xt.shape[1:]),
                          dtype=xt.dtype, device=xt.device)
        dist.reduce_scatter_tensor(out, xt, group=group)
        return out.movedim(0, dim)
    xt = xt.clone()  # gloo has no reduce-scatter: the sum's block
    dist.all_reduce(xt, group=group)
    out = xt.movedim(0, dim)
    return out if kind == "all_reduce" else _narrow(out, dim, rank, size)


class _Comm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd, dim, st):
        ctx.bwd, ctx.dim, ctx.st = bwd, dim, st
        return _comm(x, fwd, dim, st)

    @staticmethod
    def backward(ctx, g):
        return _comm(g, ctx.bwd, ctx.dim, ctx.st), None, None, None, None


def _sum(parts):
    return torch.stack(parts).sum(0)


def _collective(x, fwd, bwd, dim=0):
    """``x`` through the collective ``fwd`` forward and ``bwd`` backward
    (``_comm``'s kinds) along ``dim``; the identity outside the split or
    at size 1.  In share mode the forward's exchange is plain autograd,
    whose backward is ``bwd``: an input read by every rank sums their
    gradients, a concatenation hands each rank its block."""
    st = _state()
    if st is None or st[2] == 1:
        return x
    group, rank, size = st
    dim = dim % x.dim()
    if not isinstance(group, _Shares):
        return _Comm.apply(x, fwd, bwd, dim, st)
    if fwd == "identity":
        return x
    if fwd == "slice":
        return _narrow(x, dim, rank, size)
    if fwd == "gather":
        return group.exchange(rank, x, lambda p: torch.cat(p, dim))
    out = group.exchange(rank, x, _sum)
    return out if fwd == "all_reduce" else _narrow(out, dim, rank, size)


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """The entry of a split region: the identity; in the backward pass
    the input's gradient, partial on each process, is summed over the
    split axis.  The identity outside the split or at size 1."""
    return _collective(x, "identity", "all_reduce")


def exit_split(x: torch.Tensor) -> torch.Tensor:
    """The exit of a split region: the processes' partial outputs summed
    over the split axis; the gradient passes through.  The identity
    outside the split or at size 1."""
    return _collective(x, "all_reduce", "identity")


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """The entry of a split region from the split residual stream: the
    processes' rows of ``x`` (B, S / m, ...) all-gathered along the
    sequence; backward, the partial gradients summed and this process's
    rows kept (a reduce-scatter)."""
    return _collective(x, "gather", "reduce_scatter", 1)


def scatter_seq(x: torch.Tensor) -> torch.Tensor:
    """The exit of a split region into the split residual stream: the
    partial outputs (B, S, ...) summed over the split axis and this
    process's rows kept (a reduce-scatter); backward, the rows'
    gradients all-gathered."""
    return reduce_scatter(x, 1)


def whole_seq(x: torch.Tensor) -> torch.Tensor:
    """The processes' rows of the split stream all-gathered for a
    consumer that every process runs whole (the loss, a region left
    unsplit); backward, this process's rows of the gradient."""
    return _collective(x, "gather", "slice", 1)


def local_seq(x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a sequence every process holds whole (the
    embeddings, an unsplit region's output), entering the split stream;
    backward, the rows' gradients all-gathered."""
    return _collective(x, "slice", "gather", 1)


def reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The processes' partial ``x`` summed over the split axis and this
    process's block along ``dim`` kept; backward, the blocks' gradients
    all-gathered."""
    return _collective(x, "reduce_scatter", "gather", dim)


def region_in(x: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """The entry of a region: ``gather_seq`` (split) or ``whole_seq``
    (run whole) from a split stream (``seq``), else ``enter_split`` when
    the region is split and the identity when not."""
    if seq:
        return gather_seq(x) if split else whole_seq(x)
    return enter_split(x) if split else x


def region_out(x: torch.Tensor, split: bool, seq: bool) -> torch.Tensor:
    """The exit of a region: ``scatter_seq`` (split) or ``local_seq``
    (run whole) into a split stream (``seq``), else ``exit_split`` when
    the region is split and the identity when not."""
    if seq:
        return scatter_seq(x) if split else local_seq(x)
    return exit_split(x) if split else x


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the split axis of a detached copy
    (``x`` itself, detached, outside the split or at size 1)."""
    x = x.detach()
    st = _state()
    if st is None or st[2] == 1:
        return x
    if isinstance(st[0], _Shares):
        return st[0].exchange(st[1], x,
                              lambda p: torch.stack(p).amax(0))
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=st[0])
    return out


def local_part(t: torch.Tensor, dim: int, start: int, n: int):
    """``t``'s ``n`` entries from ``start`` along ``dim``, a view; ``t``
    itself when it already holds ``n`` there (a block a sharded step
    handed in, rather than a whole tensor to cut)."""
    return t if t.shape[dim] == n else t.narrow(dim, start, n)


def q_seq_here(sq: int, split_heads: bool) -> bool:
    """Whether a prompt chunk of ``sq`` query rows runs ``q_seq``: inside
    the split, outside training, with the heads not split, a chunk of
    more than one row whose count the split axis divides.  At a split of
    size 1 the heads path runs (the identity collectives)."""
    st = _state()
    return (st is not None and not split_heads and st[2] > 1 and sq > 1
            and sq % st[2] == 0)


# --- the contiguous caches' sequence split ---------------------------

_SEQ = None  # (groups in mesh order, shard, n) or "shares"


class SeqComm:
    """The collectives over the shards of a sequence-split cache: over
    the process groups of its mesh axes (in mesh order), or, in share
    mode, the shares' exchange (``shares`` = (the ``_Shares``, rank)).
    ``gather`` concatenates the shards' tensors along ``dim`` in shard
    order; ``sum`` and ``max`` reduce them elementwise (detached
    copies: serving has no backward pass)."""

    def __init__(self, groups=(), shares=None):
        self.groups, self.shares = tuple(groups), shares

    def _exchange(self, x, combine):
        shares, rank = self.shares
        return shares.exchange(rank, x.detach(), combine)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.shares is not None:
            return self._exchange(x, lambda p: torch.cat(p, dim))
        import torch.distributed as dist

        x = x.detach().contiguous()
        for grp in reversed(self.groups):  # innermost axis first
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(grp))]
            dist.all_gather(parts, x, group=grp)
            x = torch.cat(parts, dim)
        return x

    def _reduce(self, x, op, combine):
        if self.shares is not None:
            return self._exchange(x, combine)
        import torch.distributed as dist

        out = x.detach().clone()
        for grp in self.groups:
            dist.all_reduce(out, op=op, group=grp)
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.SUM, _sum)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MAX,
                            lambda p: torch.stack(p).amax(0))


@contextlib.contextmanager
def cache_seq_split(mesh=None, axes: Sequence[str] = ()):
    """The contiguous attention caches inside hold this process's block
    of the sequence, split major-to-minor over the mesh axes ``axes``
    of the live ``mesh``; with ``mesh`` None, in share mode, over the
    shares' axis (each share's block is its rank's).  No axes: the
    caches are whole."""
    global _SEQ
    if mesh is None:
        new = "shares" if axes else None
    elif not axes:
        new = None
    else:
        sizes, coord = axis_sizes(mesh), dict(
            zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        shard = 0
        for a in axes:
            shard = shard * sizes[a] + coord[a]
        new = ([mesh.get_group(a) for a in axes], shard,
               math.prod(sizes[a] for a in axes), tuple(axes))
    prev, _SEQ = _SEQ, new
    try:
        yield
    finally:
        _SEQ = prev


def cache_seq():
    """(SeqComm, shard, n) of the caches' sequence split inside
    ``cache_seq_split``, else None."""
    if _SEQ is None:
        return None
    if _SEQ == "shares":
        shares, rank, size = _TLS.model
        return SeqComm(shares=(shares, rank)), rank, size
    groups, shard, n, _ = _SEQ
    return SeqComm(groups), shard, n


def cache_seq_over_model() -> bool:
    """Whether the caches' sequence split (``cache_seq``) runs along the
    split axis too (in share mode always), so that the processes of a
    shard group hold different heads."""
    return _SEQ == "shares" or (_SEQ is not None and "model" in _SEQ[3])


def gather_split(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The processes' blocks of ``x`` along ``dim`` all-gathered over the
    split axis in rank order (the identity outside the split or at size
    1; serving only: no backward)."""
    return _collective(x, "gather", "slice", dim)
