"""Parameters of every ported family: seeded init, casting and tree
helpers.

Each family's ``ModelDef.shapes(cfg)`` gives its parameter tree with
``(shape, init[, std])`` leaves, mirroring the reference's ``specs``
leaf for leaf, with one difference of layout: the reference stacks
repeated blocks along a leading ``layers`` axis for ``lax.scan``, while
the port keeps each stack (``blocks``, also RWKV-6's; ``enc_blocks`` /
``dec_blocks`` of the encoder-decoder; ``rec1`` / ``rec2`` / ``attn`` of
the Griffin hybrid) as a list of per-layer dicts, its layer loop being a
Python loop.  Matrices keep the (in, out) layout and are applied as ``x @ W``.
The decoder-only LM (dense, MoE and VLM families):

    {"embed": {"tok": (V_pad, d), "head": (d, V_pad)},
     "blocks": [{"ln1": {"scale"}, "attn": {"wq", "wk", "wv", "wo"
                 [, "bq", "bk", "bv"]}, "ln2": {"scale"},
                 "ffn": {"w_gate", "w_up", "w_down"}}, ...],
     "ln_f": {"scale"}}

An MoE block's ``ffn`` holds ``router`` (d, E_pad) and the expert
stacks ``w_gate``/``w_up`` (E_pad, d, f) and ``w_down`` (E_pad, f, d)
instead (models/moe.py).  The VLM family is the same tree: its vision
tower is a stub of precomputed patch embeddings.  models/encdec.py,
models/rglru.py and models/rwkv6.py give their own trees.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.registry import get_model_def

__all__ = ["param_shapes", "init_params", "cast_params", "count_params",
           "tree_leaves", "tree_map"]


def param_shapes(cfg) -> dict:
    """The family's parameter tree of (shape, init[, std]) leaves;
    NotImplementedError for an unknown family."""
    return get_model_def(cfg).shapes(cfg)


def _leaf(shape, init, gen, device, std=None):
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "ones":
        return torch.ones(shape, device=device)
    if std is None:  # fan-in scaled normal over the in-features axis,
        # the last-but-one (d of an (E, d, f) expert stack)
        fan_in = shape[0] if len(shape) == 1 else shape[-2]
        std = (1.0 / max(1, fan_in)) ** 0.5
    return torch.randn(shape, generator=gen, device=device) * std


def _draw(tree, gen, device):
    if isinstance(tree, dict):
        return {k: _draw(v, gen, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_draw(v, gen, device) for v in tree]
    shape, init, *std = tree
    return _leaf(shape, init, gen, device, *std)


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda", *, seed: int = 0) -> dict:
    """Random float32 parameters drawn from a ``torch.Generator``, leaf
    by leaf in the order of the family's shape tree.

    The distributions are the reference's (``models/module.py``):
    fan-in scaled normals for matrices unless a leaf states its std
    (N(0, d_model**-0.5) for the token embedding, r**-0.5 for the RG-LRU
    gates), ones/zeros for norms, biases and the like.  The numbers
    differ from the reference's, which draws from ``jax.random``.
    """
    shapes = param_shapes(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return _draw(shapes, generator, dev)


def cast_params(params, dtype, device=None):
    """Compute-precision copy: every floating leaf cast to ``dtype`` (and
    moved to ``device`` when given), once, before serving."""
    def cast(t):
        t = t if device is None else t.to(device)
        return t.to(dtype) if t.is_floating_point() else t

    return tree_map(cast, params)


def count_params(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts (keys in sorted order, as
    ``jax.tree.leaves`` orders them) and lists."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; leaves are visited in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
