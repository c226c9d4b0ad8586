"""The decoder-only LM of the serving path, in PyTorch."""

from repro_torch.models.convert import from_jax_params  # noqa: F401
from repro_torch.models.module import (cast_params,  # noqa: F401
                                       count_params, init_params)
from repro_torch.models.transformer import (dtype_of,  # noqa: F401
                                            init_pools, lm_decode_paged,
                                            lm_page_specs, lm_prefill_paged)
