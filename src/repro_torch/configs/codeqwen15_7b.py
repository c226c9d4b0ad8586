"""codeqwen1.5-7b [dense]: qwen1.5-arch, MHA (hf:Qwen/CodeQwen1.5-7B)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,          # kv=32 per assignment
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
))
