"""Model-level attention block: projections, RoPE and dispatch to the
layer's ``AttentionBackend`` (core/backend.py), over a paged pool, a
contiguous cache (a ring of rotated positions included) or the encoder
keys of cross-attention."""

from __future__ import annotations

from repro_torch.core.backend import AttentionBackend, get_backend
from repro_torch.models.layers import rope

__all__ = ["attn_shapes", "attn_cache_spec", "attention_block"]


def _resolve_backend(cfg, backend=None) -> AttentionBackend:
    if isinstance(backend, AttentionBackend):
        return backend
    return get_backend(backend or cfg.backend)


def attn_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes)} of one attention sub-block's
    projections."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {"wq": ((d, q), "normal", ("embed", "heads")),
         "wk": ((d, kv), "normal", ("embed", "kv_heads")),
         "wv": ((d, kv), "normal", ("embed", "kv_heads")),
         "wo": ((q, d), "normal", ("heads", "embed"))}
    if cfg.qkv_bias:
        s.update(bq=((q,), "zeros", (None,)), bk=((kv,), "zeros", (None,)),
                 bv=((kv,), "zeros", (None,)))
    return s


def attn_cache_spec(cfg, batch: int, cache_len: int, dtype, backend=None):
    """{leaf: (shape, dtype)} of one layer's contiguous self-attention
    cache (delegates to the layer's backend)."""
    return _resolve_backend(cfg, backend).cache_spec(cfg, batch, cache_len,
                                                     dtype)


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


def attention_block(p, x, cfg, *, positions, cache=None, cache_index=None,
                    kv_len=None, kv_positions=None, page_table=None,
                    scale_base=None, causal: bool = True, window=None,
                    cross_kv=None, backend=None):
    """Attention sub-block.  Returns (out (B, S, d_model), cache).

    x: (B, S, d_model); positions: (B, S).  Modes, as the reference's:

      train:          no cache: attention over the fresh K/V;
      paged serving:  ``cache`` is this layer's pool dict and
                      ``page_table`` (B, NP) is set (with ``kv_len``):
                      prefill chunks and decode rows splice into pages
                      and attend through the page table;
      prefill:        contiguous ``cache``, ``kv_len`` None: attention
                      over the fresh K/V, written at ``cache_index``
                      (default 0);
      decode:         contiguous ``cache`` and ``kv_len`` (B,): write at
                      ``cache_index`` (an int or (B,)), then attend over
                      the cache's valid slots; ``kv_positions`` (B, L)
                      gives the position each slot holds (a ring cache,
                      whose slots are rotated), else slot i holds
                      position i;
      cross-attention: ``cross_kv`` = (k, v) (B, H_kv, S_enc, D) from
                      the encoder: no RoPE, no cache write, non-causal
                      attention on the layer's backend (the paper's
                      Sec. IV-C: a CAM search over the encoder keys).

    ``causal`` and ``window`` (default ``cfg.window``) mask the fresh
    K/V of train and prefill; decode is causal.  Caches are updated in
    place.
    """
    bk = _resolve_backend(cfg, backend)
    b, s, _ = x.shape
    q, k, v = _project(p, x, cfg)
    if cross_kv is not None:
        k, v = cross_kv
        out = bk.prefill(q, k, v, cfg, causal=False)
    else:
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        if page_table is not None and cache is not None:
            if kv_len is None:
                raise ValueError("paged cache needs page_table and kv_len")
            out, cache = bk.paged_decode(q, cache, k, v, positions,
                                         page_table, kv_len, cfg,
                                         base=scale_base)
        elif cache is not None and "v" not in cache:
            # a paged pool reached the contiguous path: fail loudly
            raise ValueError("paged cache needs page_table and kv_len")
        else:
            index = 0 if cache_index is None else cache_index
            if cache is not None and kv_len is not None:
                out, cache = bk.decode(q, cache, k, v, index, kv_len,
                                       positions, cfg,
                                       kv_positions=kv_positions,
                                       window=window)
            else:
                cache = bk.write_cache(cache, k, v, index, cfg)
                out = bk.prefill(q, k, v, cfg, causal=causal,
                                 positions=positions,
                                 window=window or cfg.window)
    out = out.transpose(1, 2).reshape(b, s, cfg.q_dim)
    return out @ p["wo"].to(x.dtype), cache
