"""moonshot-v1-16b-a3b [moe]: Moonlight 64-expert top-6
(hf:moonshotai/Moonlight-16B-A3B)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # (GQA kv=16)
    head_dim=128,
    d_ff=1408,              # per-expert FF width
    vocab=163840,
    n_experts=64,
    experts_per_token=6,
    rope_theta=5e4,
))
