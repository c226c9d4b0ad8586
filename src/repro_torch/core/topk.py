"""Hierarchical two-stage top-k selection (paper Sec. III-B / III-C4).

Stage 1 keeps the top ``stage1_k`` scores per group of ``group_size``
keys (the BA-CAM tile height); stage 2 takes a global top-``k`` over the
stage-1 candidates.

CAM scores are integers in [-d, d], so ties are everywhere.  The
reference's ``lax.top_k`` returns the lowest index first among equal
values; ``torch.topk`` promises no order.  Every selection here is a
stable descending sort sliced to k, which gives the lowest index first.

``single_stage_topk`` is the plain top-k the two-stage selection
approximates, ``topk_recall`` measures the approximation and
``hoeffding_drop_bound`` is the paper's bound on it (Sec. III-B1).
"""

from __future__ import annotations

import math

import torch

from repro_torch.utils import spans

__all__ = ["NEG_INF", "stable_topk", "single_stage_topk", "stage1_topk",
           "two_stage_topk", "topk_recall", "hoeffding_drop_bound"]

# Finite "minus infinity" for masked scores: never picked over a real
# score, finite in float32/bfloat16 arithmetic.
NEG_INF = -1.0e9


def stable_topk(x: torch.Tensor, k: int):
    """Top-k over the last axis, ties to the lowest index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _masked(scores, where):
    s = scores.to(torch.float32)
    if where is None:
        return s
    return torch.where(where, s, torch.full_like(s, NEG_INF))


def single_stage_topk(scores: torch.Tensor, k: int,
                      where: torch.Tensor | None = None):
    """Plain top-k over the last axis, compared in float32 (``where``
    masks to NEG_INF).  Returns (values (..., k) float32, indices (..., k)
    int32), ties to the lowest index."""
    v, i = stable_topk(_masked(scores, where), k)
    return v, i.to(torch.int32)


def stage1_topk(scores: torch.Tensor, group_size: int = 16,
                stage1_k: int = 2, where: torch.Tensor | None = None):
    """Stage 1 of ``two_stage_topk``: the top ``stage1_k`` scores of each
    group of ``group_size`` keys over the last axis (padded with NEG_INF
    to a group multiple), ties to the lowest index.  Returns (cand_v
    (..., groups * stage1_k) float32, cand_i int64 key indices), group
    by group: the candidates the stage-1 kernels write."""
    s = _masked(scores, where)
    *lead, n = s.shape
    pad = (-n) % group_size
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    groups = (n + pad) // group_size
    v1, i1 = stable_topk(s.reshape(*lead, groups, group_size), stage1_k)
    base = (torch.arange(groups, dtype=torch.int64, device=s.device)
            * group_size)[:, None]
    return (v1.reshape(*lead, groups * stage1_k),
            (i1 + base).reshape(*lead, groups * stage1_k))


def two_stage_topk(scores: torch.Tensor, k: int = 32, group_size: int = 16,
                   stage1_k: int = 2, where: torch.Tensor | None = None):
    """Two-stage hierarchical top-k over the last axis.

    scores: (..., N), compared in float32; ``where`` an optional validity
    mask (invalid positions get NEG_INF).  Returns (values (..., k)
    float32, indices (..., k) int32 into N); short candidate sets are
    padded with NEG_INF values and clamped indices.
    """
    n = scores.shape[-1]
    with spans.span("attn.cam.stage1"):
        cand_v, cand_i = stage1_topk(scores, group_size, stage1_k, where)
    with spans.span("attn.cam.stage2"):
        k_eff = min(k, cand_v.shape[-1])
        v2, sel = stable_topk(cand_v, k_eff)
        idx = torch.gather(cand_i, -1, sel)
        if k_eff < k:  # degenerate tiny-N case: pad to a static k
            v2 = torch.nn.functional.pad(v2, (0, k - k_eff), value=NEG_INF)
            idx = torch.nn.functional.pad(idx, (0, k - k_eff))
        # padded-region indices are clamped into range (their values are
        # NEG_INF)
        return v2, torch.clamp(idx, max=n - 1).to(torch.int32)


def topk_recall(selected_idx: torch.Tensor,
                true_idx: torch.Tensor) -> torch.Tensor:
    """recall@k: the share of the true top-k indices present in the
    selection.  Shapes (..., k) each; returns (...,) float32."""
    eq = selected_idx[..., :, None] == true_idx[..., None, :]
    return eq.any(dim=-2).to(torch.float32).mean(dim=-1)


def hoeffding_drop_bound(m: int, delta_min: float, k: int, n: int) -> float:
    """The paper's recall bound: Pr[drop any true top-k] <= k (N - k)
    exp(-2 m delta_min**2), clamped at 1.  m: Bernoulli matches (d_k for
    binary similarity); delta_min: the least normalized score margin
    around the k-th score; k, n: selection size and number of keys."""
    return float(min(1.0, k * (n - k) * math.exp(-2.0 * m * delta_min**2)))
