"""The paper's own evaluation point: BERT-Large attention geometry
(Sec. IV-C: 16 heads, d_k = d_v = 64, n = 1024) with CAMformer attention
(binary Q/K, two-stage Top-32) as the serving configuration."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="camformer-bert",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=30522,
    attn_backend="camformer",
    k_top=32,
    group_size=16,
    stage1_k=2,
))
