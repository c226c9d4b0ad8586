"""llava-next-mistral-7b [vlm]: Mistral-7B backbone, anyres vision stub
(hf:llava-hf/llava-v1.6-mistral-7b-hf)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    n_patches=576,          # one base-resolution tile (stub embeddings)
    frontend="vision",
    rope_theta=1e6,
))
