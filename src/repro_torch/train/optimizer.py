"""AdamW and learning-rate schedules, written out as the reference's
(``train/optimizer.py``) so the two agree to float32 rounding.

    opt = adamw(schedule, ...)
    state = opt.init(params)
    params, state, stats = opt.update(grads, state, params)

The update runs the reference's order: clip the gradients to a global
norm, then m and v, then the bias corrections, then ``u = m_hat /
(sqrt(v_hat) + eps) + wd * p`` and ``p - lr * u``, all in float32.
(``torch.optim.AdamW`` decays the parameter before the Adam step, a
different rounding.)  The update writes params, m and v in place (the
gradients are left as they are).  It takes the global norm over the
whole tree, then walks the leaves in ``tree_leaves`` order in groups of
at most ``GROUP_BYTES`` float32 bytes (a larger leaf is a group of its
own) and runs every stage on one group, each stage one
``torch._foreach_*`` call, before the next group: so the temporaries of
one group are live at a time, and the update needs about two groups'
bytes beside params, m, v and the gradients instead of three trees'.
Every element goes through the same operations in the same order as
with one group over all leaves, so the result is the same bit for bit.
The step count is a 0-d int32 host tensor, so the schedule and the bias
corrections are host scalars and the update reads nothing back from the
device.

Under a mesh the train step holds each parameter, m and v as this
process's block (launch/steps.py) and passes ``update`` the global
gradient norm of ``sharded_global_norm``: every distinct block counted
once, whichever processes hold copies of it.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.module import tree_leaves, tree_map

__all__ = ["adamw", "cosine_schedule", "constant_schedule", "global_norm",
           "sharded_global_norm", "clip_by_global_norm", "Optimizer",
           "GROUP_BYTES"]

_F32 = torch.float32
# the float32 bytes of one group of leaves that the update runs at a time
GROUP_BYTES = 2**30


class Optimizer(NamedTuple):
    init: Callable  # (params) -> state
    update: Callable  # (grads, state, params) -> (params, state, stats)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    to ``floor * peak_lr`` at ``total``; float32 arithmetic, as the
    reference's."""
    def fn(step):
        step = torch.as_tensor(step).to(_F32)
        warm = peak_lr * step / max(1, warmup)
        t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return fn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    norms = torch._foreach_norm([x.to(_F32) for x in tree_leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


def sharded_global_norm(blocks, counted, group=None) -> torch.Tensor:
    """The global norm of a tree sharded over processes: this process's
    float32 ``blocks`` and, leaf for leaf, ``counted`` (True where this
    process holds the first copy of the block, False where another
    process holds the same block); the squares of the counted blocks are
    summed here and all-reduced over ``group`` (default: the world)."""
    import torch.distributed as dist

    norms = torch._foreach_norm([x.to(_F32) for x in tree_leaves(blocks)])
    keep = [n for n, c in zip(norms, tree_leaves(counted)) if c]
    sq = (torch.stack(keep).square().sum() if keep
          else torch.zeros((), dtype=_F32, device=norms[0].device))
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """(float32 leaves scaled by min(1, max_norm / (norm + 1e-9)), norm);
    the input leaves are left as they are.  ``norm`` defaults to the
    tree's ``global_norm``."""
    norm = global_norm(tree) if norm is None else norm
    scaled = iter(torch._foreach_mul(
        [x.to(_F32) for x in tree_leaves(tree)], _clip_factor(norm, max_norm)))
    return tree_map(lambda _: next(scaled), tree), norm


def _clip_factor(norm, max_norm):
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _groups(leaves):
    """Runs of consecutive leaf indices of at most GROUP_BYTES float32
    bytes each; a leaf larger than that is a run of its own."""
    groups, size = [], 0
    for i, x in enumerate(leaves):
        n = 4 * x.numel()
        if not groups or size + n > GROUP_BYTES:
            groups.append([])
            size = 0
        groups[-1].append(i)
        size += n
    return groups


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=_F32),
                                 params)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, norm=None):
        """``norm``: the gradients' global norm when they are blocks of a
        sharded tree (``sharded_global_norm``); by default their own."""
        # f32 exact, on the host
        f = lambda x: float(torch.as_tensor(x, dtype=_F32, device="cpu"))
        # the step count and its scalars are host values, made on the CPU
        # whatever the default device (the dry run traces on meta)
        with torch.device("cpu"):
            step = state["step"] + 1
            lr = schedule(step)
            stepf = step.to(_F32)
            bc1 = f(1 - torch.tensor(b1, dtype=_F32) ** stepf)
            bc2 = f(1 - torch.tensor(b2, dtype=_F32) ** stepf)
            lr_f = f(lr)
        gnorm = global_norm(grads) if norm is None else norm
        scale = _clip_factor(gnorm, clip_norm)
        leaves = [tree_leaves(t) for t in (grads, state["m"], state["v"],
                                           params)]
        for idx in _groups(leaves[0]):
            gl, m, v, p = ([t[i] for i in idx] for t in leaves)
            g = torch._foreach_mul([x.to(_F32) for x in gl], scale)
            torch._foreach_mul_(m, f(b1))
            torch._foreach_add_(m, torch._foreach_mul(g, f(1 - b1)))
            torch._foreach_mul_(v, f(b2))
            gg = torch._foreach_mul(g, f(1 - b2))
            torch._foreach_mul_(gg, g)
            del g
            torch._foreach_add_(v, gg)
            del gg
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(m, bc1)
            torch._foreach_div_(u, den)
            del den
            torch._foreach_add_(u, torch._foreach_mul(p, f(weight_decay)))
            torch._foreach_sub_(p, torch._foreach_mul(u, lr_f))
            del u
        return params, {"m": state["m"], "v": state["v"], "step": step}, {
            "grad_norm": gnorm, "lr": lr}

    return Optimizer(init=init, update=update)
