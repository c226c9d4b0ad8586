"""Weight and state bridge between the reference's layout and the port's.

The reference LM's parameters (``lm_specs``) are nested dicts with
``embed.{tok, head}``, ``blocks.*`` stacked along a leading ``layers``
axis, and ``ln_f``; its train state is ``{"params", "opt": {"m", "v",
"step"}}`` with m and v shaped like the parameters.  The port keeps
``blocks`` as a list of per-layer dicts (models/module.py), matrices in
the same (in, out) layout.

* :func:`unstack_blocks` / :func:`stack_blocks` turn one layout into the
  other for any such tree (numpy leaves on the reference's side; the
  port's leaves may be tensors on any device).  The checkpoint format
  (train/checkpoint.py) is the reference's stacked layout.
* :func:`from_jax_params` and :func:`from_jax_state` take the
  reference's trees as numpy arrays (``np.asarray`` of each leaf: the
  port never imports the reference) and check them against a config.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.module import _check_supported

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


def unstack_blocks(tree, device) -> dict:
    """The reference's layout (numpy leaves, every ``blocks`` dict stacked
    along a leading layers axis) -> the port's (tensors on ``device``,
    ``blocks`` a list of per-layer dicts)."""
    if not isinstance(tree, dict):
        return _tensor(tree, device)
    out = {}
    for k, v in tree.items():
        if k == "blocks" and isinstance(v, dict):
            n = np.asarray(_first(v)).shape[0]
            out[k] = [_tree(v, device, i) for i in range(n)]
        else:
            out[k] = unstack_blocks(v, device)
    return out


def _first(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_blocks(tree):
    """The port's layout -> the reference's, as numpy arrays on the host
    (each per-layer ``blocks`` list stacked along a new leading axis)."""
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


def from_jax_params(params_np, cfg, device="cuda") -> dict:
    """Map the reference's parameter tree (numpy leaves) to the port's.

    Leaves keep their dtype (the reference's float32 masters); the
    engine casts them to ``cfg.dtype`` once.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    n = np.asarray(params_np["blocks"]["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params carry {n} layers, config has "
                         f"{cfg.n_layers}")
    return unstack_blocks(params_np, dev)


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
