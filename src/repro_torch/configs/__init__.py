"""Architecture configs (assigned pool + the paper's own eval point)."""

from repro_torch.configs import (  # noqa: F401  — registration side effects
    camformer_bert,
    codeqwen15_7b,
    granite_moe_3b,
    llava_next_mistral_7b,
    mistral_nemo_12b,
    moonshot_v1_16b,
    qwen15_110b,
    recurrentgemma_2b,
    rwkv6_3b,
    whisper_medium,
    yi_34b,
)
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    get_config,
    list_archs,
    smoke_config,
)

ASSIGNED_ARCHS = [
    "whisper-medium",
    "qwen1.5-110b",
    "mistral-nemo-12b",
    "yi-34b",
    "codeqwen1.5-7b",
    "rwkv6-3b",
    "moonshot-v1-16b-a3b",
    "granite-moe-3b-a800m",
    "llava-next-mistral-7b",
    "recurrentgemma-2b",
]
