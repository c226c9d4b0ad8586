"""Token samplers for the serving engine.

The engine of this port samples greedily; the keyed categorical draw of
the reference (threefry ``fold_in`` per request and token index) is not
ported yet, so requests with ``temperature > 0`` are refused at submit.
``apply_top_k`` / ``apply_top_p`` are the row-wise logit filters, and
``request_key`` is the host-side per-request key the scheduler records.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["greedy", "request_key", "apply_top_k", "apply_top_p"]

_MASKED = -1e9  # filtered logits (matches the vocab-padding mask value)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax (first index among ties) as int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_top_k(logits: torch.Tensor, k) -> torch.Tensor:
    """Keep each row's k highest logits, mask the rest to -1e9.

    logits: (..., V); k: scalar or (...,) int — 0 disables the filter for
    that row.
    """
    v = logits.shape[-1]
    k = torch.as_tensor(k, dtype=torch.int64,
                        device=logits.device).expand(logits.shape[:-1])
    eff = torch.where(k > 0, torch.clamp(k, max=v), torch.full_like(k, v))
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, (eff - 1)[..., None])
    return torch.where(logits < kth, torch.full_like(logits, _MASKED), logits)


def apply_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus filter: keep each row's smallest high-probability set whose
    cumulative softmax mass reaches p, mask the rest to -1e9.  The top-1
    token is always kept; ties break by stable descending sort."""
    p = torch.as_tensor(p, dtype=torch.float32, device=logits.device)
    p = p.expand(logits.shape[:-1])[..., None]
    sl, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    sp = torch.softmax(sl, dim=-1)
    cum = torch.cumsum(sp, dim=-1)
    keep = (cum - sp) < p  # mass BEFORE this token is still short of p
    masked = torch.where(keep, sl, torch.full_like(sl, _MASKED))
    return torch.empty_like(masked).scatter_(-1, idx, masked)


def request_key(seed: int, rid: int) -> np.ndarray:
    """Deterministic per-request raw key data, derived on the host."""
    return np.random.SeedSequence(entropy=(int(seed), int(rid))).generate_state(
        2, dtype=np.uint32)
