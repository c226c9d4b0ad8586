"""Input stand-ins for every (arch x shape) cell: shapes and dtypes.

``input_specs`` gives the train/prefill batch of a ``SHAPES`` entry and
``serve_input_specs`` the decode step's, each as {name: (shape, dtype)}
with torch dtypes; ``batch_axes`` gives their logical sharding axes (the
reference returns both from one call).  Modality frontends
are stubs, as in the reference: VLM cells get patch embeddings, audio
cells precomputed frame embeddings.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES

__all__ = ["input_specs", "serve_input_specs", "batch_axes"]


def input_specs(cfg, shape_name: str) -> dict:
    """{name: (shape, dtype)} of a train or prefill batch."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    specs = {}
    s_text = s
    if cfg.family == "vlm":
        s_text = s - cfg.n_patches  # patches + text fill the assigned seq
        specs["image_embeds"] = ((b, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
    if cfg.family == "audio":
        specs["audio_features"] = ((b, cfg.enc_len, cfg.d_model),
                                   torch.bfloat16)
    specs["tokens"] = ((b, s_text), torch.int32)
    if sh["kind"] == "train":
        specs["labels"] = ((b, s_text), torch.int32)
        specs["loss_mask"] = ((b, s_text), torch.float32)
    return specs


def serve_input_specs(cfg, shape_name: str) -> dict:
    """Decode-step inputs: one new token against a seq_len cache."""
    b = SHAPES[shape_name]["global_batch"]
    return {name: ((b,), torch.int32) for name in ("tokens", "pos", "kv_len")}


def batch_axes(cfg, shape_name: str, *, serve: bool = False) -> dict:
    """{name: logical axes} of ``input_specs`` (or ``serve_input_specs``)."""
    if serve:
        return {name: ("batch",) for name in serve_input_specs(cfg,
                                                               shape_name)}
    return {name: ("batch", None, "embed") if len(shape) == 3
            else ("batch", "seq")
            for name, (shape, _) in input_specs(cfg, shape_name).items()}
