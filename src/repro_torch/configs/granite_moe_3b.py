"""granite-moe-3b-a800m [moe]: 40-expert top-8
(hf:ibm-granite/granite-3.0-3b-a800m-base)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,            # d_k = 64: exactly one BA-CAM tile (paper sweet spot)
    d_ff=512,               # per-expert FF width
    vocab=49155,
    n_experts=40,
    experts_per_token=8,
    n_experts_padded=48,    # EP divisibility on the 16-way model axis
))
