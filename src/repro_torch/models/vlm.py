"""LLaVA-Next-style VLM: the decoder-only LM backbone with a vision stub.

As in the reference (``models/vlm.py``), the vision tower and anyres
tiling are a stub: the caller supplies precomputed patch embeddings
``batch["image_embeds"]`` (B, n_patches, d_model), which the training
loss and the contiguous prefill prepend to the text sequence.  Paged
serving is text-only: the backbone pages exactly like the LM, and the
reference's VLM gives no ``verify_paged``, so speculative decoding is
refused.
"""

from __future__ import annotations

from repro_torch.models import layers as L
from repro_torch.models import transformer as T

__all__ = ["loss", "make_model_def"]


def loss(params, batch, cfg):
    """batch: image_embeds (B, P, d), tokens (B, S_text), labels (B,
    S_text) and optional loss_mask.  The hidden state at absolute
    position P - 1 + i predicts text token i, so the text-aligned slice
    starts at the last image slot."""
    img = batch["image_embeds"]
    p = img.shape[1]
    x, _, aux = T.lm_hidden(params, batch["tokens"], cfg, prefix_embeds=img)
    x_text = x[:, p - 1:-1] if x.shape[1] > p else x
    loss_val, stats = L.chunked_cross_entropy(
        x_text, params["embed"], batch["labels"][:, :x_text.shape[1]], cfg,
        loss_mask=batch.get("loss_mask"))
    stats.update(aux)
    return loss_val, stats


def make_model_def() -> T.ModelDef:
    return T.ModelDef(
        shapes=T.lm_shapes,
        cache_specs=T.lm_cache_specs,
        # batch: tokens (B, S_text) and image_embeds (B, P, d)
        prefill=T.lm_prefill,
        decode=T.lm_decode,
        loss=loss,
        # text-only serving: the backbone pages exactly like the LM
        page_specs=T.lm_page_specs,
        prefill_paged=T.lm_prefill_paged,
        decode_paged=T.lm_decode_paged,
    )
