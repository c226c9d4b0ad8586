"""mistral-nemo-12b [dense]: 128k ctx (hf:mistralai/Mistral-Nemo-Base-2407)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,           # attention dim 4096 != d_model (Nemo quirk)
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
))
