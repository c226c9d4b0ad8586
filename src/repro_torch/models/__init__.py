"""The model families in PyTorch: the decoder-only LMs (dense, MoE, VLM:
the training loss, the paged serving path and the contiguous-cache
path), the encoder-decoder (models/encdec.py), the Griffin hybrid
(models/rglru.py) and RWKV-6 (models/rwkv6.py), these three on the loss
and the contiguous path."""

from repro_torch.models.convert import (from_jax_params,  # noqa: F401
                                        from_jax_state)
from repro_torch.models.module import (cast_params,  # noqa: F401
                                       count_params, init_params)
from repro_torch.models.registry import get_model_def  # noqa: F401
from repro_torch.models.transformer import (ModelDef,  # noqa: F401
                                            dtype_of, init_pools,
                                            lm_cache_specs, lm_decode,
                                            lm_decode_paged, lm_loss,
                                            lm_page_specs,
                                            lm_prefill, lm_prefill_paged,
                                            lm_verify_paged, make_model_def)
