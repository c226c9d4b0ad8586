"""Token-choice top-k Mixture-of-Experts FFN, in PyTorch.

The reference's group-wise one-hot dispatch (``models/moe.py``): tokens
are cut row-major into groups of ``gt = min(MOE_GROUP, B*S)`` (groups
span batch rows); within a group every routing slot places its tokens
into a per-expert buffer of ``cap`` rows through a one-hot dispatch
tensor (group, token, expert, capacity), and tokens past an expert's
capacity are dropped.  Dispatch, the experts' gated-silu FFN and the
gated combine are the reference's four einsums, in the compute type.

The routing is integer work and is reproduced bit for bit:

  * experts at index ``>= n_experts`` (padding, ``padded_experts``) get
    logit -1e9 before the float32 softmax;
  * the top-k breaks ties toward the lower expert index, as
    ``lax.top_k`` does (a stable descending sort; ``torch.topk``
    promises no tie order);
  * slots fill in order 0..k-1 with a running per-(group, expert) fill:
    a token's buffer position is the number of earlier (slot, token)
    pairs of its group, in slot-major order, routed to its expert.  The
    reference carries ``fill`` across a Python loop over slots; one
    cumulative sum over the slot-major (k * gt) axis gives the same
    integers without the loop.  A token is kept iff its position is
    below ``cap``.

Every tensor has a static shape (no host read, no boolean indexing), so
one forward's launches do not depend on the routing.  Padding tokens
(inactive slots, right-padded prompt rows) route and take capacity like
any other token, as in the reference.

Inside ``sharding.partitioning.sharded_batch`` (the sharded train step)
x is this process's rows of the global batch.  Its dispatch groups are
the global batch's only when it holds a multiple of ``MOE_GROUP``
tokens (else ``group_size`` raises).  The load-balancing loss of the
global batch, ``e * sum(density * mean prob)``, is not a mean of
per-process products: the slot-0 expert counts (and with them the token
count) are summed over the batch axes, and each process returns ``e *
sum(density * its prob sums) / tokens``, whose sum over the batch axes
is the global loss (and whose gradient is this process's share of it);
the drop share is returned the same way.  Unsharded, the sums are the
batch's own and the formula is the reference's.

Inside ``sharding.partitioning.model_split`` with the experts split
(the train step's ``tp`` profile), this process holds the expert stacks
of its experts ``[rank * E_l, (rank + 1) * E_l)`` and the router whole:
the routing and the dispatch are computed the same on every process,
each process runs its experts and their part of the combine, and the
parts are summed over ``model``.  The router's gradient reaches only
the local experts' gates on each process, and the train step sums it
over ``model``; the load-balancing loss, the same value everywhere,
takes its gradient on the first process only, so the sum counts it
once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import partitioning as P

__all__ = ["MOE_GROUP", "Routing", "moe_shapes", "group_size", "capacity",
           "route", "apply_moe"]

MOE_GROUP = 64  # tokens per dispatch group


def moe_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes)} of the MoE FFN: the router (d, E_pad),
    whose fan-in std d**-0.5 is the reference's explicit router scale,
    and the expert stacks (E_pad, d, f) / (E_pad, f, d)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    return {"router": ((d, e), "normal", ("embed", "experts")),
            "w_gate": ((e, d, f), "normal",
                       ("experts", "embed", "expert_mlp")),
            "w_up": ((e, d, f), "normal", ("experts", "embed", "expert_mlp")),
            "w_down": ((e, f, d), "normal",
                       ("experts", "expert_mlp", "embed"))}


def group_size(n_tokens: int) -> int:
    """Tokens per dispatch group for a (B, S) batch of ``n_tokens``.
    Raises where the reference asserts: B*S must be a multiple of it;
    inside ``sharded_batch``, B*S must be a multiple of ``MOE_GROUP``."""
    if P.in_sharded_batch() and n_tokens % MOE_GROUP:
        raise ValueError(
            f"MoE dispatch under a sharded batch: this process holds "
            f"{n_tokens} tokens, not a multiple of MOE_GROUP={MOE_GROUP}, "
            f"so its dispatch groups would not be the global batch's")
    gt = min(MOE_GROUP, n_tokens)
    if gt < 1 or n_tokens % gt:
        raise ValueError(
            f"MoE dispatch: B*S={n_tokens} tokens is not a multiple of the "
            f"group size gt={gt} (min({MOE_GROUP}, B*S))")
    return gt


def capacity(cfg, gt: int) -> int:
    """Per-(group, expert) buffer rows: ceil(gt * k * capacity_factor /
    n_experts), at least 1, over the REAL expert count."""
    e, k = cfg.n_experts, cfg.experts_per_token
    return max(1, int(-(-gt * k * cfg.capacity_factor // e)))


class Routing(NamedTuple):
    """One batch's routing, per group g and token t of the group."""

    probs: torch.Tensor  # (g, gt, E_pad) float32 router softmax
    gates: torch.Tensor  # (g, gt, k) float32, renormalised
    eidx: torch.Tensor  # (g, gt, k) int64 chosen experts, slot order
    pos: torch.Tensor  # (g, gt, k) int64 buffer row of each choice
    keep: torch.Tensor  # (g, gt, k) bool: pos < cap


def route(router, xg, cfg, cap: int) -> Routing:
    """The routing of grouped tokens xg (g, gt, d) (see module doc)."""
    g, gt, _ = xg.shape
    e, ep, k = cfg.n_experts, cfg.padded_experts, cfg.experts_per_token
    logits = xg.to(torch.float32) @ router.to(torch.float32)  # (g, gt, ep)
    if ep > e:  # padded experts are never routed to
        logits[..., e:] = -1e9
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[..., :k], eidx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # slot-major (g, k * gt, ep) one-hots: the exclusive prefix count of
    # each (slot, token)'s expert is its buffer position
    oh = F.one_hot(eidx.transpose(1, 2).reshape(g, k * gt), ep)
    before = torch.cumsum(oh, dim=1) - oh
    pos = torch.gather(before, 2, eidx.transpose(1, 2).reshape(g, k * gt, 1))
    pos = pos.reshape(g, k, gt).transpose(1, 2)
    return Routing(probs, gates, eidx, pos, pos < cap)


def apply_moe(p, x, cfg, seq: bool = False):
    """x: (B, S, d) -> ((B, S, d), aux), aux = {"moe_aux_loss",
    "moe_drop_frac"} as float32 scalars (the Switch load-balancing loss
    and the share of (token, slot) choices dropped).  With ``seq`` x and
    the output are this process's rows of the split residual stream
    (``res_seq``): the tokens route on the gathered sequence, as the
    reference's ``constrain(xg, ("batch", None, "embed"))``."""
    e, ep, k = cfg.n_experts, cfg.padded_experts, cfg.experts_per_token
    dt = x.dtype
    el = p["w_gate"].shape[0]  # experts held here
    split = P.split_here(el, ep)
    if split:
        P.note_split("experts", el)
    x = P.region_in(x, split, seq)
    b, s, d = x.shape
    t = b * s
    gt = group_size(t)
    g = t // gt
    cap = capacity(cfg, gt)
    xg = x.reshape(g, gt, d)
    r = route(p["router"], xg, cfg, cap)

    # Switch load-balancing loss: slot-0 density times the mean prob,
    # over the global batch (batch_sum: the identity unsharded); each
    # token has one slot-0 choice, so n counts the batch's tokens
    count0 = P.batch_sum(
        F.one_hot(r.eidx[..., 0], ep).to(torch.float32).sum((0, 1)))
    n = count0.sum()
    probs = r.probs
    if split and P.split_rank()[0] > 0:  # its gradient counted once
        probs = probs.detach()
    aux_loss = e * torch.sum(count0 / n * probs.sum((0, 1))) / n
    # per-slot drop share (each slot routes all tokens), over k
    kept = r.keep.sum((0, 1)).to(torch.float32)  # (k,)
    drop = torch.sum(t - kept) / n / k

    # dispatch / combine (g, gt, E_pad, cap): each choice writes its
    # (expert, row) entry, 1 / its gate when kept and 0 when dropped (at
    # the clamped row).  A token's choices name distinct experts, so the
    # writes of one token never collide and every entry holds one term.
    cell = (r.eidx * cap + torch.clamp(r.pos, 0, cap - 1)).reshape(g, gt, k)
    keep = r.keep.to(torch.float32)
    disp = torch.zeros((g, gt, ep * cap), dtype=dt, device=x.device)
    disp.scatter_(2, cell, keep.to(dt))
    comb = torch.zeros((g, gt, ep * cap), dtype=torch.float32,
                       device=x.device)
    comb.scatter_(2, cell, keep * r.gates)
    disp = disp.reshape(g, gt, ep, cap)
    comb = comb.reshape(g, gt, ep, cap)
    if split:  # this process's experts
        e0 = P.split_rank()[0] * el if el < ep else 0
        disp, comb = disp[:, :, e0:e0 + el], comb[:, :, e0:e0 + el]

    buf = torch.einsum("gtec,gtd->gecd", disp, xg)
    gate = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt))
    up = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    y = torch.einsum("gecf,efd->gecd", F.silu(gate) * up, p["w_down"].to(dt))
    out = torch.einsum("gtec,gecd->gtd", comb.to(dt), y)
    return P.region_out(out.reshape(b, s, d), split, seq), {
        "moe_aux_loss": aux_loss, "moe_drop_frac": drop}
