"""recurrentgemma-2b [hybrid]: RG-LRU + local attention 1:2
(arXiv:2402.19427)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    act="geglu",
    window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    rnn_width=2560,
    conv_width=4,
    tie_embeddings=True,
))
