"""Decoder-only transformer LM (dense / GQA / MoE): the training loss,
the serving forward over paged KV pools and the contiguous-cache
prefill/decode.

The layer stack is a Python loop over the per-layer parameter dicts and
per-layer pool or cache dicts (uniform and mixed ``layer_backends``
stacks alike); each layer binds its own backend
(``cfg.backend_for(layer)``).  On the train path (no caches), under
autograd with ``cfg.remat == "full"``, each block runs in
``torch.utils.checkpoint``: its activations are recomputed in the
backward pass, as the reference's ``jax.checkpoint`` of the scanned
block.  A config with ``n_experts`` runs each block's FFN through
models/moe.py.  ``make_model_def`` bundles
the entry points as the reference's ``ModelDef`` does; models/vlm.py
reuses them with patch embeddings prepended.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
# imported here, not lazily by the first checkpoint call: that import's
# frames would hold the first remat step's frames (and tensors) in a
# reference cycle until the cycle collector ran
import torch._dynamo  # noqa: F401
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import backends_for
from repro_torch.models import layers as L
from repro_torch.models.attention import attention_block, attn_shapes
from repro_torch.models.moe import apply_moe, moe_shapes
from repro_torch.sharding import partitioning as P

__all__ = ["ModelDef", "make_model_def", "dtype_of", "block_shapes",
           "arange_positions", "run_block",
           "embed_shapes", "lm_shapes", "lm_cache_specs", "lm_page_specs",
           "init_pools", "last_logits", "lm_hidden", "lm_loss",
           "lm_prefill", "lm_decode", "lm_prefill_paged",
           "lm_verify_paged", "lm_decode_paged"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def embed_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes[, std])} of the token embedding (std
    d_model**-0.5) and, untied, the (d, V_pad) output head."""
    v, d = cfg.padded_vocab, cfg.d_model
    s = {"tok": ((v, d), "embed", ("vocab", "embed"), d**-0.5)}
    if not cfg.tie_embeddings:
        s["head"] = ((d, v), "normal", ("embed", "vocab"))
    return s


def block_shapes(cfg) -> dict:
    """{module: {leaf: (shape, init, axes)}} of one transformer
    block."""
    return {"ln1": L.norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln2": L.norm_shapes(cfg),
            "ffn": moe_shapes(cfg) if cfg.n_experts else L.mlp_shapes(cfg)}


def lm_shapes(cfg) -> dict:
    """The decoder-only LM's parameter tree with (shape, init, axes[,
    std]) leaves (models/module.py draws it): ``blocks`` a list of per-layer
    dicts."""
    return {"embed": embed_shapes(cfg),
            "blocks": [block_shapes(cfg) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_shapes(cfg)}


def lm_page_specs(cfg, n_pages: int, page_size: int, max_batch: int):
    """Per-layer pool specs, a list of {leaf: (shape, dtype)}."""
    dt = dtype_of(cfg)
    return [bk.page_spec(cfg, n_pages, page_size, max_batch, dt)
            for bk in backends_for(cfg)]


def lm_cache_specs(cfg, batch: int, cache_len: int):
    """Per-layer contiguous cache specs, a list of {leaf: (shape, dtype)}
    (the reference stacks a uniform stack along a layers axis; the port
    keeps one dict per layer for every stack)."""
    dt = dtype_of(cfg)
    return [bk.cache_spec(cfg, batch, cache_len, dt)
            for bk in backends_for(cfg)]


def init_pools(specs, device):
    """Zero-filled pools or caches from a tree of (shape, dtype) leaves
    (``lm_page_specs``, or a family's ``ModelDef.cache_specs``), in the
    tree's structure.  Zeros, not empty memory: the candidate indices of
    masked slots are clamped into the cache and read there at weight
    0."""
    if isinstance(specs, dict):
        return {k: init_pools(v, device) for k, v in specs.items()}
    if isinstance(specs, list):
        return [init_pools(v, device) for v in specs]
    shape, dt = specs
    return torch.zeros(shape, dtype=dt, device=device)


class ModelDef(NamedTuple):
    """The entry points a family gives its callers, as the reference's
    ``ModelDef`` bundles them: the parameter shapes, the training loss
    and the contiguous-cache steps the launch steps call, and the
    paged-serving interface ``ServeEngine`` needs (None for a family
    without a paged cache).

      shapes(cfg) -> parameter tree of (shape, init, axes[, std])
          leaves, axes the logical sharding axes (the reference's
          ``specs``; ``models.init_params`` draws it)
      cache_specs(cfg, batch, cache_len) -> tree of (shape, dtype)
          leaves (``init_pools`` allocates it)
      prefill(params, batch, caches, cfg) -> (logits, caches)
      decode(params, tokens, pos, kv_len, caches, cfg) -> (logits, caches)
      loss(params, batch, cfg) -> (loss, aux)
      page_specs(cfg, n_pages, page_size, max_batch) -> per-layer specs
      prefill_paged(params, batch, pools, table, cfg) -> (logits, pools)
      decode_paged(params, tokens, pos, kv_len, pools, table, cfg[, base])
      verify_paged(params, batch, pools, table, cfg) -> ((B,S,V), pools)
    """

    shapes: Callable[..., Any]
    cache_specs: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    loss: Callable[..., Any]
    page_specs: Optional[Callable[..., Any]] = None
    prefill_paged: Optional[Callable[..., Any]] = None
    decode_paged: Optional[Callable[..., Any]] = None
    verify_paged: Optional[Callable[..., Any]] = None


def make_model_def() -> ModelDef:
    return ModelDef(shapes=lm_shapes, cache_specs=lm_cache_specs,
                    prefill=lm_prefill, decode=lm_decode, loss=lm_loss,
                    page_specs=lm_page_specs, prefill_paged=lm_prefill_paged,
                    decode_paged=lm_decode_paged,
                    verify_paged=lm_verify_paged)


def _apply_block(p, x, cfg, *, positions, cache, cache_index, kv_len,
                 page_table, scale_base, backend, seq=False):
    """One block; returns (x, cache, aux) with aux the MoE FFN's
    {moe_aux_loss, moe_drop_frac} (empty for a dense FFN).  With ``seq``
    x holds this process's rows of the split residual stream
    (``res_seq``): the norms and residual adds run on them, each region
    on the gathered sequence."""
    h, cache = attention_block(
        p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg, positions=positions,
        cache=cache, cache_index=cache_index, kv_len=kv_len,
        page_table=page_table, scale_base=scale_base, backend=backend,
        seq=seq)
    x = x + h
    ff_in = L.apply_norm(p["ln2"], x, cfg)
    if cfg.n_experts:
        ff, aux = apply_moe(p["ffn"], ff_in, cfg, seq=seq)
    else:
        ff, aux = L.apply_mlp(p["ffn"], ff_in, cfg, seq=seq), {}
    return x + ff, cache, aux


def arange_positions(b, s, device):
    """Positions 0..S-1 (B, S) int32, the same for every row."""
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def run_block(block, cfg, train, *args, **kw):
    """``block(*args, **kw)``; on the train path under autograd with
    ``cfg.remat == "full"``, in ``torch.utils.checkpoint``, so that its
    activations are recomputed in the backward pass (not in a share of
    ``partitioning.run_shares``, whose state is gone by the backward)."""
    if (train and cfg.remat == "full" and torch.is_grad_enabled()
            and not P.in_shares()):
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args, **kw)


def lm_hidden(params, tokens, cfg, *, positions=None, caches=None,
              kv_len=None, page_table=None, cache_index=None,
              scale_base=None, prefix_embeds=None):
    """tokens (B, S) -> (final hidden states (B, P + S, d), caches, aux).

    ``caches`` (one dict per layer, paged pools or contiguous caches) are
    written in place; None (training) threads no cache.
    ``prefix_embeds`` (B, P, d) (the VLM's patch embeddings) are
    prepended to the token embeddings; ``positions`` defaults to
    arange(P + S) for every row.  aux holds the per-layer means of the
    MoE FFN's ``moe_aux_loss`` and ``moe_drop_frac`` (float32 scalars, 0
    for a dense stack).

    Training inside ``partitioning.model_split`` (the ``tp`` profile)
    splits the residual stream's sequence (``res_seq``, the reference's
    ``constrain(x, ("batch", "res_seq", "embed"))``) when the ``model``
    axis divides P + S: between blocks each process holds its (P + S) /
    m rows, and the final hidden states are all-gathered whole for the
    loss, as the reference hands it a sequence-replicated copy."""
    dt = dtype_of(cfg)
    x = L.embed_lookup(params["embed"], tokens, cfg, dt)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dt), x], dim=1)
    if positions is None:
        positions = arange_positions(*x.shape[:2], tokens.device)
    if cfg.abs_pos == "sinusoidal" or not cfg.use_rope:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(dt)
    seq = caches is None and P.seq_split_here(x.shape[1])
    if seq:
        x = P.local_seq(x)
        P.note_split("res_rows", x.shape[1])
    aux_sum = torch.zeros(2, dtype=torch.float32, device=x.device)
    for i, bk in enumerate(backends_for(cfg)):
        block_args = (params["blocks"][i], x, cfg)
        block_kw = dict(positions=positions,
                        cache=None if caches is None else caches[i],
                        cache_index=cache_index, kv_len=kv_len,
                        page_table=page_table, scale_base=scale_base,
                        backend=bk, seq=seq)
        # the train path (no caches) recomputes each block in the backward
        x, cache, aux = run_block(_apply_block, cfg, caches is None,
                                  *block_args, **block_kw)
        if caches is not None:
            caches[i] = cache
        if aux:
            aux_sum = aux_sum + torch.stack([aux["moe_aux_loss"],
                                             aux["moe_drop_frac"]])
    aux_mean = aux_sum / cfg.n_layers
    aux = {"moe_aux_loss": aux_mean[0], "moe_drop_frac": aux_mean[1]}
    x = L.apply_norm(params["ln_f"], x, cfg)
    return (P.whole_seq(x) if seq else x), caches, aux


def lm_loss(params, batch, cfg):
    """Causal LM loss. batch: tokens (B, S), labels (B, S) and optional
    loss_mask (B, S).  Returns (loss, aux): the chunked cross entropy
    (models/layers.py), plus ``0.01 * moe_aux_loss`` for an MoE stack;
    aux holds ``ce``, ``tokens``, ``moe_aux_loss`` and
    ``moe_drop_frac``."""
    x, _, aux = lm_hidden(params, batch["tokens"], cfg)
    loss, stats = L.chunked_cross_entropy(
        x, params["embed"], batch["labels"], cfg,
        loss_mask=batch.get("loss_mask"))
    if cfg.n_experts:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    stats.update(aux)
    return loss, stats


def last_logits(params, x, cfg):
    """Vocabulary logits (B, V_pad) float32 of the last position of the
    final hidden states x (B, S, d)."""
    return _head_logits(params, x[:, -1], cfg)


def _head_logits(params, last, cfg):
    """Vocabulary logits (..., V_pad) float32 for final hidden states
    (..., d): computed in the compute type, vocab pad columns at -1e9.
    Inside ``partitioning.model_split`` with the vocabulary split (the
    sharded serving steps), this process's block of the columns, the
    logits of its vocabulary rows."""
    head = L.head_matrix(params["embed"], cfg, last.dtype)
    split, v0 = L._vocab_split(head.shape[-1], cfg)
    if split:
        last = P.enter_split(last)
    logits = (last @ head).to(torch.float32)
    if logits.shape[-1] + v0 > cfg.vocab:  # padding columns never sampled
        logits[..., max(cfg.vocab - v0, 0):] = -1e9
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
        x, caches, _ = lm_hidden(
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


def lm_verify_paged(params, batch, caches, page_table, cfg):
    """Speculative-decode verification over the paged Sq > 1 path.

    The contract of ``lm_prefill_paged``, but returns the logits of EVERY
    suffix position, (B, S, V_pad): row j is the target distribution of
    the token after position offsets + j.  Runs under ``spec_verify``
    (stateful backends score each column with its own sequential
    ``k_scale`` and stash the chunk's key means) and never slices the
    k + 1 tokens into prefill chunks.
    """
    cfg = cfg.replace(spec_verify=True, prefill_chunk=0)
    x, caches = _paged_suffix_hidden(params, batch, caches, page_table, cfg)
    return _head_logits(params, x, cfg), caches


def lm_prefill(params, batch, caches, cfg):
    """Prefill into contiguous caches: the forward writing each layer's
    cache from index 0.  batch: tokens (B, S), every row a full prompt,
    and optional image_embeds (B, P, d), prepended (the cache then holds
    P + S positions).

    With ``cfg.prefill_chunk`` set, S > chunk, S a chunk multiple and no
    image_embeds, the prompt runs in chunks that attend to the cache so
    far: chunk i is written at i * chunk and goes through
    ``backend.decode`` with kv_len (i + 1) * chunk for every row.
    Returns (last-token logits (B, V_pad) float32, caches).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    chunk = cfg.prefill_chunk
    image = batch.get("image_embeds")
    if chunk and s > chunk and s % chunk == 0 and image is None:
        steps = torch.arange(chunk, dtype=torch.int32, device=tokens.device)
        for i in range(s // chunk):
            pos = (i * chunk + steps)[None].expand(b, chunk)
            kvl = torch.full((b,), (i + 1) * chunk, dtype=torch.int32,
                             device=tokens.device)
            x, caches, _ = lm_hidden(
                params, tokens[:, i * chunk:(i + 1) * chunk], cfg,
                positions=pos, caches=caches, cache_index=i * chunk,
                kv_len=kvl)
        return last_logits(params, x, cfg), caches
    x, caches, _ = lm_hidden(params, tokens, cfg, caches=caches,
                             cache_index=0, prefix_embeds=image)
    return last_logits(params, x, cfg), caches


def lm_decode(params, tokens, pos, kv_len, caches, cfg):
    """One decode step against contiguous caches. tokens, pos, kv_len:
    (B,); each row's token is written at its own ``pos``.  Returns
    (logits (B, V_pad) float32, caches)."""
    b = tokens.shape[0]
    x, caches, _ = lm_hidden(
        params, tokens.reshape(b, 1), cfg,
        positions=pos.reshape(b, 1).to(torch.int32), caches=caches,
        cache_index=pos.to(torch.int32), kv_len=kv_len.to(torch.int32))
    return last_logits(params, x, cfg), caches


def lm_decode_paged(params, tokens, pos, kv_len, caches, page_table, cfg,
                    base=None):
    """One decode step against the paged pools. tokens/pos/kv_len/base:
    (B,).  Returns (logits (B, V_pad), pools)."""
    b = tokens.shape[0]
    x, caches, _ = lm_hidden(
        params, tokens.reshape(b, 1), cfg,
        positions=pos.reshape(b, 1).to(torch.int32), caches=caches,
        kv_len=kv_len.to(torch.int32), page_table=page_table,
        scale_base=base)
    return last_logits(params, x, cfg), caches
