"""whisper-medium [audio]: enc-dec, conv frontend stubbed (arXiv:2212.04356)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    enc_layers=24,          # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA (GQA kv=16)
    head_dim=64,
    d_ff=4096,
    vocab=51865,
    act="gelu",
    norm="layer",
    use_rope=False,
    abs_pos="sinusoidal",
    enc_len=1500,           # 30 s window after conv stride-2 (stub supplies embeddings)
    frontend="audio",
))
