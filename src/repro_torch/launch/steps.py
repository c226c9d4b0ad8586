"""Step functions of the contiguous-cache path: prefill and serve.

    prefill_step(params, batch, caches) -> (logits, caches)
    serve_step(params, tokens, pos, kv_len, caches) -> (logits, caches)

``md`` is the family's ``ModelDef`` (``models.get_model_def(cfg)``:
dense, MoE or VLM).  Each step casts the parameters to the config's
compute type first (a no-op for parameters already in it) and calls the
model's entry point; the batch goes through as given, so a VLM prefill
takes ``batch["image_embeds"]`` (B, P, d) beside ``batch["tokens"]``.
The train step and the sharding assembly of the reference's
``launch/steps.py`` are not ported yet.
"""

from __future__ import annotations

from repro_torch.models.module import cast_params
from repro_torch.models.transformer import dtype_of

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(md, cfg):
    dt = dtype_of(cfg)

    def prefill_step(params, batch, caches):
        return md.prefill(cast_params(params, dt), batch, caches, cfg)

    return prefill_step


def make_serve_step(md, cfg):
    dt = dtype_of(cfg)

    def serve_step(params, tokens, pos, kv_len, caches):
        return md.decode(cast_params(params, dt), tokens, pos, kv_len,
                         caches, cfg)

    return serve_step
