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
heads, MLP columns, vocabulary rows, experts) and brackets each split
region with ``enter_split`` (identity forward, the input gradient summed
over ``model`` backward) and ``exit_split`` (the partial outputs summed
over ``model`` forward, identity backward).  At a ``model`` of 1 both
are the identity.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch

__all__ = [
    "PARAM_RULES", "SERVE_PARAM_RULES", "ACT_RULES", "CACHE_RULES",
    "resolve_spec", "tree_pspecs", "placements", "constrain",
    "set_parallelism_profile", "get_parallelism_profile", "axis_sizes",
    "sharded_batch", "batch_sum", "in_sharded_batch", "model_split",
    "split_rank", "split_here", "note_split", "enter_split", "exit_split",
    "model_max", "SPLIT_SEEN",
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

# what the split code last ran on, by region (the local heads, MLP
# columns, vocabulary rows and experts): a record for tests and probes
SPLIT_SEEN: dict = {}


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
    """(rank, size) along the split axis inside ``model_split``, else
    None."""
    return None if _MODEL is None else _MODEL[1:]


def split_here(local: int, whole: int) -> bool:
    """Whether a region whose parameter extent is ``local`` here and
    ``whole`` in full runs split: inside ``model_split`` when the train
    step kept the block split (``local < whole``), or at a split of size
    1, where the split code runs on whole blocks with identity
    collectives.  A block gathered whole (the resolver left the dim
    unsharded) runs whole."""
    if _MODEL is None:
        return False
    return _MODEL[2] == 1 or local < whole


def note_split(region: str, n: int) -> None:
    """Record that ``region`` ran on ``n`` local units (``SPLIT_SEEN``)."""
    SPLIT_SEEN[region] = n


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_split(x: torch.Tensor) -> torch.Tensor:
    """The entry of a split region: the identity; in the backward pass
    the input's gradient, partial on each process, is summed over the
    split axis.  The identity outside ``model_split`` or at size 1."""
    if _MODEL is None or _MODEL[2] == 1:
        return x
    return _Enter.apply(x, _MODEL[0])


def exit_split(x: torch.Tensor) -> torch.Tensor:
    """The exit of a split region: the processes' partial outputs summed
    over the split axis; the gradient passes through.  The identity
    outside ``model_split`` or at size 1."""
    if _MODEL is None or _MODEL[2] == 1:
        return x
    return _Exit.apply(x, _MODEL[0])


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the split axis of a detached copy
    (``x`` itself, detached, outside ``model_split`` or at size 1)."""
    x = x.detach()
    if _MODEL is None or _MODEL[2] == 1:
        return x
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_MODEL[0])
    return out
