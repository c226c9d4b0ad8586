"""GPipe-style pipeline parallelism over ``torch.distributed`` (the
reference's ``sharding/pipeline.py``).

Layers are split into S stages along a ``pipe`` mesh axis, one process
a stage; microbatches flow through the stage ring with send/recv
handoffs.  A schedule of (n_micro + S - 1) ticks fills and drains the
pipeline; the bubble is (S - 1) / (n_micro + S - 1) of it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.module import tree_map

__all__ = ["pipeline_forward"]


def pipeline_forward(stage_fn, stage_params, x_micro, mesh,
                     axis: str = "pipe"):
    """Run microbatches through a stage ring.

    Args:
      stage_fn: (params_for_stage, h) -> h   (same shape in/out).
      stage_params: a tree whose leaves have a leading stage axis of the
        size of ``mesh`` 's ``axis`` (each process takes its stage's
        slice).
      x_micro: (n_micro, mb, ...) microbatched input, the same on every
        process of the ring.
      mesh: a live ``DeviceMesh`` with ``axis``.

    Each tick, stage 0 ingests microbatch t, every stage applies its
    layers, the last stage emits microbatch t - S + 1, and activations
    rotate one stage forward (``batch_isend_irecv``).  The last stage's
    outputs are then summed ring-wide, the others contributing zeros, so
    every process returns the (n_micro, mb, ...) outputs.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    params = tree_map(lambda a: a[stage], stage_params)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    h = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        h_in = x_micro[min(t, n_micro - 1)] if stage == 0 else h
        h_out = stage_fn(params, h_in)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - n_stages + 1] = h_out
        if n_stages > 1:  # rotate activations one stage forward
            h = torch.empty_like(h_out)
            ops = [dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, h, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            h = h_out
    if stage != n_stages - 1:
        outs = torch.zeros_like(outs)
    dist.all_reduce(outs, group=group)
    return outs

