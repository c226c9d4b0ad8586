"""Token samplers for the serving engine.

``sample_step_keyed`` is the engine's per-tick entry point: every row of
the batch carries its own temperature / top-k / top-p, its own raw rng
key and its generated-token index, and draws from ``fold_in(key,
index)``, so a sampled id is a pure function of ``(seed, rid, index)``
whatever tick, slot or batch produced it.  The draws are the reference's
``jax.random.categorical`` bit for bit (``serving/prng.py``).  Keys are
``(B, 2)`` int64 tensors holding the uint32 words of
``request_key``.  ``sample_step`` is the single-key variant and
``sample`` the single-policy one; ``apply_top_k`` / ``apply_top_p`` are
the row-wise logit filters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving import prng

__all__ = ["greedy", "sample", "sample_step", "sample_step_keyed",
           "request_key", "apply_top_k", "apply_top_p"]

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


def _draw_flat(key, z):
    """``jax.random.categorical(key, z)`` for z (B, V) under ONE raw key
    (2,): the noise covers the flattened (B * V) shape."""
    b, v = z.shape
    g = prng.gumbel(key, b * v).reshape(b, v)
    return torch.argmax(g + z, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, rng: torch.Tensor, *,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """Single-policy sampling (python scalars). logits: (B, V); rng: a
    raw key (2,) int64."""
    if temperature <= 0.0:
        return greedy(logits)
    z = logits / temperature
    if top_k:
        z = apply_top_k(z, top_k)
    if top_p < 1.0:
        z = apply_top_p(z, top_p)
    return _draw_flat(rng, z)


def _filtered(logits, temperature, top_k, top_p):
    """(temperature > 0 mask (B,), filtered tempered logits (B, V))."""
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=logits.device)
    safe_t = torch.where(t > 0, t, torch.ones_like(t))[:, None]
    return t > 0, apply_top_p(apply_top_k(logits / safe_t, top_k), top_p)


def sample_step(logits: torch.Tensor, rng: torch.Tensor, temperature,
                top_k, top_p) -> torch.Tensor:
    """Per-row sampling for one tick under one raw key (2,).

    logits: (B, V); temperature/top_k/top_p: (B,).  Rows with
    temperature <= 0 are greedy; the rest filter, then draw at their own
    temperature.
    """
    hot, z = _filtered(logits, temperature, top_k, top_p)
    return torch.where(hot, _draw_flat(rng, z), greedy(logits))


def sample_step_keyed(logits, keys, index, temperature, top_k, top_p):
    """Per-row keyed sampling for one engine tick.

    logits: (B, V); keys: (B, 2) int64 raw per-request keys; index: (B,)
    generated-token index being sampled; temperature/top_k/top_p: (B,).
    Rows with temperature <= 0 are greedy; the rest filter, then draw
    categorically from ``fold_in(key, index)``.
    """
    hot, z = _filtered(logits, temperature, top_k, top_p)
    c = prng.categorical(prng.fold_in(keys, index), z).to(torch.int32)
    return torch.where(hot, c, greedy(logits))
