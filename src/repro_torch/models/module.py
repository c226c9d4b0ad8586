"""Parameters of the decoder-only LM (the dense, MoE and VLM families):
shapes, seeded init and casting.

The parameter tree mirrors the reference's ``lm_specs`` leaf for leaf,
with one difference of layout: the reference stacks block parameters
along a leading ``layers`` axis for ``lax.scan``, while the port keeps
``blocks`` as a list of per-layer dicts (its layer loop is a Python
loop).  Matrices keep the (in, out) layout and are applied as ``x @ W``.

    {"embed": {"tok": (V_pad, d), "head": (d, V_pad)},
     "blocks": [{"ln1": {"scale"}, "attn": {"wq", "wk", "wv", "wo"
                 [, "bq", "bk", "bv"]}, "ln2": {"scale"},
                 "ffn": {"w_gate", "w_up", "w_down"}}, ...],
     "ln_f": {"scale"}}

An MoE block's ``ffn`` holds ``router`` (d, E_pad) and the expert
stacks ``w_gate``/``w_up`` (E_pad, d, f) and ``w_down`` (E_pad, f, d)
instead (models/moe.py).  The VLM family is the same tree: its vision
tower is a stub of precomputed patch embeddings.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.moe import moe_shapes
from repro_torch.models.registry import get_model_def

__all__ = ["block_shapes", "init_params", "cast_params", "count_params",
           "tree_leaves", "tree_map"]


def _check_supported(cfg):
    get_model_def(cfg)  # raises NotImplementedError for an unported family
    if cfg.act != "silu" or cfg.abs_pos or not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name!r}: only the gated-silu, RoPE transformer is ported")


def block_shapes(cfg) -> dict:
    """{module: {leaf: (shape, init)}} of one transformer block."""
    d, q, kv, f = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    norm = {"scale": ((d,), "ones")}
    if cfg.norm == "layer":
        norm["bias"] = ((d,), "zeros")
    attn = {"wq": ((d, q), "normal"), "wk": ((d, kv), "normal"),
            "wv": ((d, kv), "normal"), "wo": ((q, d), "normal")}
    if cfg.qkv_bias:
        attn.update(bq=((q,), "zeros"), bk=((kv,), "zeros"),
                    bv=((kv,), "zeros"))
    if cfg.n_experts:
        ffn = moe_shapes(cfg)
    else:
        ffn = {"w_gate": ((d, f), "normal"), "w_up": ((d, f), "normal"),
               "w_down": ((f, d), "normal")}
    return {"ln1": dict(norm), "attn": attn, "ln2": dict(norm), "ffn": ffn}


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


def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda", *, seed: int = 0) -> dict:
    """Random float32 parameters drawn from a ``torch.Generator``.

    The distributions are the reference's (``models/module.py``):
    fan-in scaled normals for matrices, N(0, d_model**-0.5) for the token
    embedding, ones/zeros for norms and biases.  The numbers differ from
    the reference's, which draws from ``jax.random``.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    v, d = cfg.padded_vocab, cfg.d_model
    embed = {"tok": _leaf((v, d), "embed", generator, dev, std=d**-0.5)}
    if not cfg.tie_embeddings:
        embed["head"] = _leaf((d, v), "normal", generator, dev)
    blocks = []
    for _ in range(cfg.n_layers):
        blocks.append({
            mod: {name: _leaf(shape, init, generator, dev)
                  for name, (shape, init) in leaves.items()}
            for mod, leaves in block_shapes(cfg).items()})
    ln_f = {"scale": torch.ones((d,), device=dev)}
    if cfg.norm == "layer":
        ln_f["bias"] = torch.zeros((d,), device=dev)
    return {"embed": embed, "blocks": blocks, "ln_f": ln_f}


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
