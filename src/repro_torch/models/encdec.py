"""Whisper-style encoder-decoder (arXiv:2212.04356): the ``encdec`` and
``audio`` families.

As in the reference (``models/encdec.py``), the conv/mel frontend is a
stub: the caller supplies precomputed frame embeddings
``batch["audio_features"]`` (B, enc_len, d_model).  The backbone is the
reference's: pre-LN layer-norm blocks, plain GELU MLPs, multi-head
attention without RoPE, sinusoidal absolute positions.  The encoder
attends non-causally; each decoder block runs causal self-attention over
its cache, then cross-attention to the encoder memory, whose K/V it
projects anew in every layer at every step, as the reference does.  The
layer's backend serves both: on ``camformer`` the cross-attention is a
non-causal CAM search over the encoder keys (the paper's Sec. IV-C).

Parameters: ``enc_blocks`` and ``dec_blocks`` are lists of per-layer
dicts (the reference stacks them, models/convert.py maps the two).
Caches: ``{"self": [per-layer self-attention cache], "memory": (B,
enc_len, d)}``, written in place.  Under autograd with ``cfg.remat ==
"full"`` each block of the train path recomputes in the backward.

Training inside ``sharding.partitioning.model_split`` (the ``tp``
profile) splits the heads of the encoder's self-attention and of the
decoder's self- and cross-attention, and the MLP's hidden units, over
``model`` (models/attention.py, layers.py); the residual stream keeps
whole rows (the reference constrains it to ``"seq"``, never
``"res_seq"``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_block, attn_cache_spec,
                                          attn_shapes)
from repro_torch.models.transformer import (ModelDef, arange_positions,
                                            dtype_of, embed_shapes,
                                            last_logits, run_block)
from repro_torch.sharding import partitioning as P

__all__ = ["shapes", "encode", "cache_specs", "loss", "prefill", "decode",
           "make_model_def"]


def shapes(cfg) -> dict:
    def enc_block():
        return {"ln1": L.norm_shapes(cfg), "attn": attn_shapes(cfg),
                "ln2": L.norm_shapes(cfg), "mlp": L.mlp_shapes(cfg)}

    def dec_block():
        return {"ln1": L.norm_shapes(cfg), "self_attn": attn_shapes(cfg),
                "ln_cross": L.norm_shapes(cfg),
                "cross_attn": attn_shapes(cfg), "ln2": L.norm_shapes(cfg),
                "mlp": L.mlp_shapes(cfg)}

    return {"embed": embed_shapes(cfg),
            "enc_blocks": [enc_block() for _ in range(cfg.enc_layers)],
            "enc_ln_f": L.norm_shapes(cfg),
            "dec_blocks": [dec_block() for _ in range(cfg.n_layers)],
            "ln_f": L.norm_shapes(cfg)}


def _enc_block(p, h, cfg, pos):
    a, _ = attention_block(p["attn"], L.apply_norm(p["ln1"], h, cfg), cfg,
                           positions=pos, causal=False)
    h = h + a
    return h + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg)


def encode(params, features, cfg, *, train: bool = False):
    """features (B, enc_len, d_model), the stub frame embeddings ->
    encoder memory (B, enc_len, d_model) in the compute type."""
    dt = dtype_of(cfg)
    b, s, _ = features.shape
    pos = arange_positions(b, s, features.device)
    x = (features.to(dt)
         + L.sinusoidal_positions(pos, cfg.d_model).to(dt))
    for p in params["enc_blocks"]:
        x = run_block(_enc_block, cfg, train, p, x, cfg, pos)
    return L.apply_norm(params["enc_ln_f"], x, cfg)


def _cross_kv(p, memory, cfg):
    """Cross-attention K/V (B, H_kv, S_enc, D) projected from the encoder
    memory (no bias, as in the reference).

    Inside ``partitioning.model_split`` with the heads split, the memory
    enters the layer's split region here: this process projects it with
    its ``wk``/``wv`` columns (its kv heads; all of them under
    ``qheads``), and the memory's gradient, partial on each process, is
    summed over ``model`` in every decoder layer, which the encoder's
    gradients need whole."""
    dt = memory.dtype
    b, s, _ = memory.shape
    if P.split_here(p["wq"].shape[1], cfg.q_dim):
        memory = P.enter_split(memory)
    hk = p["wk"].shape[1] // cfg.head_dim
    k = (memory @ p["wk"].to(dt)).reshape(b, s, hk, cfg.head_dim)
    v = (memory @ p["wv"].to(dt)).reshape(b, s, hk, cfg.head_dim)
    return k.transpose(1, 2), v.transpose(1, 2)


def _dec_block(p, h, cfg, memory, cache, positions, cache_index, kv_len):
    a, cache = attention_block(
        p["self_attn"], L.apply_norm(p["ln1"], h, cfg), cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        kv_len=kv_len, causal=True)
    h = h + a
    a, _ = attention_block(
        p["cross_attn"], L.apply_norm(p["ln_cross"], h, cfg), cfg,
        positions=positions, cross_kv=_cross_kv(p["cross_attn"], memory,
                                                cfg))
    h = h + a
    h = h + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], h, cfg), cfg)
    return h, cache


def _decode_stack(params, tokens, cfg, memory, caches, *, positions=None,
                  cache_index=None, kv_len=None):
    """Decoder hidden states (B, S, d) after ``ln_f``; ``caches`` None is
    the train path (no cache, remat when configured)."""
    dt = dtype_of(cfg)
    b, s = tokens.shape
    x = L.embed_lookup(params["embed"], tokens, cfg, dt)
    if positions is None:
        positions = arange_positions(b, s, tokens.device)
    x = x + L.sinusoidal_positions(positions, cfg.d_model).to(dt)
    for i, p in enumerate(params["dec_blocks"]):
        cache = None if caches is None else caches["self"][i]
        x, cache = run_block(_dec_block, cfg, caches is None, p, x, cfg,
                             memory, cache, positions, cache_index, kv_len)
        if caches is not None:
            caches["self"][i] = cache
    return L.apply_norm(params["ln_f"], x, cfg)


def cache_specs(cfg, batch: int, cache_len: int) -> dict:
    """{"self": [per-layer self-attention cache], "memory": the encoder
    output, reread by every decode step}, (shape, dtype) leaves."""
    dt = dtype_of(cfg)
    return {"self": [attn_cache_spec(cfg, batch, cache_len, dt)
                     for _ in range(cfg.n_layers)],
            "memory": ((batch, cfg.enc_len, cfg.d_model), dt)}


def loss(params, batch, cfg):
    """batch: audio_features (B, enc_len, d), tokens / labels (B, S) and
    optional loss_mask.  Returns (loss, {"ce", "tokens"})."""
    memory = encode(params, batch["audio_features"], cfg, train=True)
    x = _decode_stack(params, batch["tokens"], cfg, memory, None)
    return L.chunked_cross_entropy(x, params["embed"], batch["labels"], cfg,
                                   loss_mask=batch.get("loss_mask"))


def prefill(params, batch, caches, cfg):
    """Encode ``audio_features`` into ``caches["memory"]``, then run the
    decoder over the prompt ``tokens`` (B, S), writing its caches from
    index 0.  Returns (last-token logits (B, V_pad) float32, caches)."""
    memory = encode(params, batch["audio_features"], cfg)
    caches["memory"].copy_(memory)
    x = _decode_stack(params, batch["tokens"], cfg, memory, caches,
                      cache_index=0)
    return last_logits(params, x, cfg), caches


def decode(params, tokens, pos, kv_len, caches, cfg):
    """One decoder step against the caches; tokens, pos, kv_len (B,).
    Returns (logits (B, V_pad) float32, caches)."""
    b = tokens.shape[0]
    x = _decode_stack(params, tokens.reshape(b, 1), cfg, caches["memory"],
                      caches, positions=pos.reshape(b, 1).to(torch.int32),
                      cache_index=pos.to(torch.int32),
                      kv_len=kv_len.to(torch.int32))
    return last_logits(params, x, cfg), caches


def make_model_def() -> ModelDef:
    return ModelDef(shapes=shapes, cache_specs=cache_specs, prefill=prefill,
                    decode=decode, loss=loss)
