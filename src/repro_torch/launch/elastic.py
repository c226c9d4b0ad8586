"""Elastic scaling: restore any checkpoint onto any mesh (the reference's
``launch/elastic.py``).

Checkpoints store whole arrays (train/checkpoint.py), so rescaling is:
take the new mesh, re-derive each leaf's placements from the same logical
axes (``launch/steps.state_specs``), and give each process its block.
``verify_rescale`` compares two states, sharded on any meshes or not,
bit for bit after gathering them.
"""

from __future__ import annotations

import torch

from repro_torch.launch.steps import map_specs, state_specs
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.sharding.partitioning import placements
from repro_torch.train.checkpoint import restore_checkpoint

__all__ = ["rescale_state", "verify_rescale"]


def rescale_state(ckpt_dir: str, md, cfg, new_mesh, step=None):
    """Load checkpoint ``step`` (default: the latest) sharded for
    ``new_mesh``: returns (state of DTensor blocks, step)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shapes, specs = state_specs(md, cfg, new_mesh)
    dev = new_mesh.device_type

    def empty(shape, spec):
        plc = placements(spec, new_mesh)
        local, _ = compute_local_shape_and_global_offset(shape, new_mesh, plc)
        return DTensor.from_local(torch.empty(local, device=dev), new_mesh,
                                  plc, run_check=False)

    build = lambda key: map_specs(empty, shapes[key], specs[key])
    into = {"params": build("params"), "opt": {
        "m": build("params"), "v": build("params"),
        "step": torch.zeros((), dtype=torch.int32)}}
    return restore_checkpoint(ckpt_dir, into, step, mesh=new_mesh)


def verify_rescale(state_a, state_b) -> bool:
    """Bit-identity of two states, each gathered whole (every process of
    a sharded state's mesh must call this)."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().cpu()

    flat_a = tree_leaves(tree_map(whole, state_a))
    flat_b = tree_leaves(tree_map(whole, state_b))
    return len(flat_a) == len(flat_b) and all(
        a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(flat_a, flat_b))
