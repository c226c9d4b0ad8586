"""Hamming Attention Distillation (HAD): the training objective.

A student with binarized Q/K is distilled from a full-precision teacher
by matching attention distributions (paper ref [32]).  These are the
reference's distillation losses (``core/had.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import stable_topk

__all__ = ["attention_kl", "row_topk_overlap", "had_loss"]


def attention_kl(teacher_logits, student_logits, mask=None):
    """KL(teacher || student) between attention rows, averaged over rows.

    Shapes: (..., Sq, Skv) logits; ``mask`` a bool broadcastable to them
    (False = masked position, logit -1e9 on both sides).
    """
    if mask is not None:
        neg = torch.full((), -1e9, dtype=teacher_logits.dtype,
                         device=teacher_logits.device)
        teacher_logits = torch.where(mask, teacher_logits, neg)
        student_logits = torch.where(mask, student_logits, neg)
    t = torch.log_softmax(teacher_logits, dim=-1)
    s = torch.log_softmax(student_logits, dim=-1)
    kl = torch.sum(torch.exp(t) * (t - s), dim=-1)  # (..., Sq)
    return kl.mean()


def row_topk_overlap(teacher_logits, student_logits, k: int = 32):
    """Mean overlap of per-row top-k sets (a recall@k diagnostic); ties
    go to the lower index, as ``lax.top_k``'s."""
    _, ti = stable_topk(teacher_logits, k)
    _, si = stable_topk(student_logits, k)
    eq = ti[..., :, None] == si[..., None, :]
    return eq.any(-1).to(torch.float32).mean()


def had_loss(task_loss, teacher_logits, student_logits, mask=None,
             alpha: float = 1.0):
    """Total HAD objective: task CE + alpha * attention KL."""
    return task_loss + alpha * attention_kl(teacher_logits, student_logits,
                                            mask)
