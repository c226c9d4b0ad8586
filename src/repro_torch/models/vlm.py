"""LLaVA-Next-style VLM: the decoder-only LM backbone with a vision stub.

As in the reference (``models/vlm.py``), the vision tower and anyres
tiling are a stub: the caller supplies precomputed patch embeddings
``batch["image_embeds"]`` (B, n_patches, d_model), which the contiguous
prefill prepends to the text sequence.  Paged serving is text-only: the
backbone pages exactly like the LM, and the reference's VLM gives no
``verify_paged``, so speculative decoding is refused.  The training
``loss`` waits for the train step.
"""

from __future__ import annotations

from repro_torch.models import transformer as T

__all__ = ["make_model_def"]


def make_model_def() -> T.ModelDef:
    return T.ModelDef(
        # batch: tokens (B, S_text) and image_embeds (B, P, d)
        prefill=T.lm_prefill,
        decode=T.lm_decode,
        # text-only serving: the backbone pages exactly like the LM
        page_specs=T.lm_page_specs,
        prefill_paged=T.lm_prefill_paged,
        decode_paged=T.lm_decode_paged,
    )
