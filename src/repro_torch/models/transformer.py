"""Decoder-only transformer LM over paged KV pools (the serving forward).

The layer stack is a Python loop over the per-layer parameter dicts and
per-layer pool dicts (uniform and mixed ``layer_backends`` stacks alike);
each layer binds its own backend (``cfg.backend_for(layer)``).
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import backends_for
from repro_torch.models import layers as L
from repro_torch.models.attention import attention_block

__all__ = ["dtype_of", "lm_page_specs", "init_pools", "lm_hidden",
           "lm_prefill_paged", "lm_decode_paged"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def lm_page_specs(cfg, n_pages: int, page_size: int, max_batch: int):
    """Per-layer pool specs, a list of {leaf: (shape, dtype)}."""
    dt = dtype_of(cfg)
    return [bk.page_spec(cfg, n_pages, page_size, max_batch, dt)
            for bk in backends_for(cfg)]


def init_pools(specs, device) -> list:
    """Zero-filled pools from ``lm_page_specs``."""
    return [{name: torch.zeros(shape, dtype=dt, device=device)
             for name, (shape, dt) in layer.items()} for layer in specs]


def _apply_block(p, x, cfg, *, positions, cache, kv_len, page_table,
                 scale_base, backend):
    h, cache = attention_block(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, positions=positions,
        cache=cache, kv_len=kv_len, page_table=page_table,
        scale_base=scale_base, backend=backend)
    x = x + h
    x = x + L.apply_mlp(p["ffn"], L.apply_norm(p["ln2"], x, cfg), cfg)
    return x, cache


def lm_hidden(params, tokens, cfg, *, positions, caches, kv_len, page_table,
              scale_base=None):
    """tokens (B, S) -> final hidden states (B, S, d); pools in place."""
    x = L.embed_lookup(params["embed"], tokens, cfg, dtype_of(cfg))
    for i, bk in enumerate(backends_for(cfg)):
        x, caches[i] = _apply_block(
            params["blocks"][i], x, cfg, positions=positions,
            cache=caches[i], kv_len=kv_len, page_table=page_table,
            scale_base=scale_base, backend=bk)
    return L.apply_norm(params["ln_f"], x, cfg), caches


def _head_logits(params, last, cfg):
    """Vocabulary logits (B, V_pad) float32 for final hidden states
    (B, d): computed in the compute type, vocab pad columns at -1e9."""
    dt = last.dtype
    if cfg.tie_embeddings:
        head = params["embed"]["tok"].to(dt).T
    else:
        head = params["embed"]["head"].to(dt)
    logits = (last @ head).to(torch.float32)
    if logits.shape[-1] > cfg.vocab:  # vocab-padding columns never sampled
        logits[..., cfg.vocab:] = -1e9
    return logits


def _paged_suffix_hidden(params, batch, caches, page_table, cfg):
    """Hidden states (B, S, d) of right-padded suffixes at positions
    ``offsets + arange(S)`` (see ``lm_prefill_paged``)."""
    tokens, lens = batch["tokens"], batch["lens"].to(torch.int32)
    b, s = tokens.shape
    dev = tokens.device
    offsets = batch.get("offsets")
    offsets = (torch.zeros((b,), dtype=torch.int32, device=dev)
               if offsets is None else offsets.to(torch.int32))
    scale_base = batch.get("scale_base")
    scale_base = offsets if scale_base is None else scale_base.to(torch.int32)
    chunk = cfg.prefill_chunk
    if not (chunk and s > chunk and s % chunk == 0):
        chunk = s
    xs = []
    for c0 in range(0, s, chunk):
        pos = (offsets[:, None] + c0
               + torch.arange(chunk, dtype=torch.int32, device=dev)[None])
        x, caches = lm_hidden(
            params, tokens[:, c0:c0 + chunk], cfg, positions=pos,
            caches=caches, kv_len=lens, page_table=page_table,
            scale_base=scale_base)
        xs.append(x)
    return torch.cat(xs, dim=1), caches


def lm_prefill_paged(params, batch, caches, page_table, cfg):
    """Batched prefill into the paged pools.

    batch: tokens (B, S) right-padded prompt SUFFIXES; lens (B,) TOTAL
    valid lengths (0 = inactive slot on the trash page); optional offsets
    (B,) — each slot's first computed position (positions below it live
    in already-written pages: a COW shared prefix or the slot's own
    earlier chunks) — and scale_base (B,), the k_scale origin (default
    offsets).  With cfg.prefill_chunk set and S a chunk multiple, the
    suffix runs in chunks.  Returns (last-token logits (B, V_pad), pools).
    """
    lens = batch["lens"].to(torch.int32)
    offsets = batch.get("offsets")
    if offsets is None:
        offsets = torch.zeros_like(lens)
    x, caches = _paged_suffix_hidden(params, batch, caches, page_table, cfg)
    # the final valid token sits at suffix row (lens - offsets - 1)
    last_row = torch.clamp(lens - offsets.to(torch.int32) - 1, 0,
                           x.shape[1] - 1).long()
    last = x[torch.arange(x.shape[0], device=x.device), last_row]
    return _head_logits(params, last, cfg), caches


def lm_decode_paged(params, tokens, pos, kv_len, caches, page_table, cfg,
                    base=None):
    """One decode step against the paged pools. tokens/pos/kv_len/base:
    (B,).  Returns (logits (B, V_pad), pools)."""
    b = tokens.shape[0]
    x, caches = lm_hidden(
        params, tokens.reshape(b, 1), cfg,
        positions=pos.reshape(b, 1).to(torch.int32), caches=caches,
        kv_len=kv_len.to(torch.int32), page_table=page_table,
        scale_base=base)
    return _head_logits(params, x[:, -1], cfg), caches
