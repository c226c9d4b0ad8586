"""Model-level attention block: projections, RoPE and dispatch to the
layer's paged ``AttentionBackend`` (core/backend.py)."""

from __future__ import annotations

from repro_torch.core.backend import AttentionBackend, get_backend
from repro_torch.models.layers import rope

__all__ = ["attention_block"]


def _resolve_backend(cfg, backend=None) -> AttentionBackend:
    if isinstance(backend, AttentionBackend):
        return backend
    return get_backend(backend or cfg.backend)


def _project(p, x, cfg):
    """QKV projections (+ optional bias) into (B, heads, S, head_dim)."""
    dt = x.dtype
    b, s, _ = x.shape
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = (q + p["bq"].to(dt), k + p["bk"].to(dt),
                   v + p["bv"].to(dt))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)
    return q, k, v


def attention_block(p, x, cfg, *, positions, cache, kv_len, page_table,
                    scale_base=None, backend=None):
    """Paged self-attention sub-block (prefill chunks and decode rows).

    x: (B, S, d_model); positions: (B, S); cache: this layer's pool dict
    (updated in place); kv_len: (B,); page_table: (B, NP).  Returns
    (out (B, S, d_model), cache).
    """
    bk = _resolve_backend(cfg, backend)
    b, s, _ = x.shape
    q, k, v = _project(p, x, cfg)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out, cache = bk.paged_decode(q, cache, k, v, positions, page_table,
                                 kv_len, cfg, base=scale_base)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), cache
