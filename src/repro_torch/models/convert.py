"""Weight bridge: the reference's parameter pytree -> the port's tree.

The reference LM's parameters (``lm_specs``) are nested dicts with
``embed.{tok, head}``, ``blocks.*`` stacked along a leading ``layers``
axis, and ``ln_f``.  Given that tree as numpy arrays (``np.asarray`` of
each leaf — the port never imports the reference), :func:`from_jax_params`
builds the port's tree (models/module.py): the same leaves, ``blocks``
split into a list of per-layer dicts, matrices kept in (in, out) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.module import _check_supported

__all__ = ["from_jax_params"]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(node, device, index=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, index) for k, v in node.items()}
    return _tensor(node if index is None else np.asarray(node)[index],
                   device)


def from_jax_params(params_np, cfg, device="cuda") -> dict:
    """Map the reference's parameter tree (numpy leaves) to the port's.

    Leaves keep their dtype (the reference's float32 masters); the
    engine casts them to ``cfg.dtype`` once.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    blocks = params_np["blocks"]
    n = np.asarray(blocks["ln1"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"params carry {n} layers, config has "
                         f"{cfg.n_layers}")
    return {
        "embed": _tree(params_np["embed"], dev),
        "blocks": [_tree(blocks, dev, i) for i in range(n)],
        "ln_f": _tree(params_np["ln_f"], dev),
    }
