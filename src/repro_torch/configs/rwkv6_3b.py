"""rwkv6-3b [ssm]: Finch, attention-free, data-dependent decay
(arXiv:2404.05892).  CAMformer technique inapplicable (no QK^T);
runs long_500k natively."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,             # d_model / rwkv_head_dim (informational)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    use_rope=False,
))
