"""Weight and state bridge between the reference's layout and the port's.

The reference's parameters (each family's ``specs``) are nested dicts
whose repeated blocks are stacked along a leading ``layers`` axis:
``blocks`` of the decoder-only LM and of RWKV-6, ``enc_blocks`` /
``dec_blocks`` of the encoder-decoder, ``rec1`` / ``rec2`` / ``attn`` of
the Griffin hybrid (its trailing ``tail_rec*`` layers are unstacked).  Its train
state is ``{"params", "opt": {"m", "v", "step"}}`` with m and v shaped
like the parameters.  The port keeps each stack as a list of per-layer
dicts (models/module.py), matrices in the same (in, out) layout.

* :func:`unstack_blocks` / :func:`stack_blocks` turn one layout into the
  other (numpy leaves on the reference's side; the port's leaves may be
  tensors on any device); unstacking reads which subtrees are stacks
  from the family's parameter tree.  The checkpoint format
  (train/checkpoint.py) is the reference's stacked layout.
* :func:`from_jax_params` and :func:`from_jax_state` take the
  reference's trees as numpy arrays (``np.asarray`` of each leaf: the
  port never imports the reference) and check every leaf's shape
  against the config's parameter tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.module import param_shapes

__all__ = ["from_jax_params", "from_jax_state", "stack_blocks",
           "unstack_blocks"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    return _tensor(node if index is None else np.asarray(node)[index],
                   device)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def unstack_blocks(tree, shapes, device) -> dict:
    """The reference's layout (numpy leaves) -> the port's (tensors on
    ``device``), read against the port's parameter tree ``shapes``
    (``param_shapes``): where that holds a list, the reference's subtree
    is a stack of layers along a leading axis."""
    if isinstance(shapes, list):
        n = np.asarray(_first(tree)).shape[0]
        return [_tree(tree, device, i) for i in range(n)]
    if isinstance(tree, dict):
        shapes = shapes if isinstance(shapes, dict) else {}
        return {k: unstack_blocks(v, shapes.get(k), device)
                for k, v in tree.items()}
    return _tensor(tree, device)


def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_blocks(tree):
    """The port's layout -> the reference's, as numpy arrays on the host
    (each per-layer list stacked along a new leading axis)."""
    if isinstance(tree, dict):
        return {k: stack_blocks(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _stack([stack_blocks(v) for v in tree])
    return _numpy(tree)


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers])
                for k in layers[0]}
    return np.stack(layers)


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return tuple(tree[0] if isinstance(tree, tuple) else tree.shape)


def from_jax_params(params_np, cfg, device="cuda") -> dict:
    """Map the reference's parameter tree (numpy leaves) to the port's,
    raising unless its structure and every leaf shape are the config's.

    Leaves keep their dtype (the reference's float32 masters); the
    engine casts them to ``cfg.dtype`` once.
    """
    shapes = param_shapes(cfg)
    want = _shape_tree(shapes)
    params = unstack_blocks(params_np, shapes, resolve_device(device))
    got = _shape_tree(params)
    if got != want:
        raise ValueError(f"{cfg.name!r}: the parameters' shapes are not "
                         f"the config's ({got} != {want})")
    return params


def from_jax_state(state_np, cfg, device="cuda") -> dict:
    """Map the reference's train state (numpy leaves) to the port's:
    params, m and v as :func:`from_jax_params`, and the step as a 0-d
    int32 host tensor (train/optimizer.py)."""
    opt = state_np["opt"]
    return {"params": from_jax_params(state_np["params"], cfg, device),
            "opt": {"m": from_jax_params(opt["m"], cfg, device),
                    "v": from_jax_params(opt["v"], cfg, device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32)}}
