"""Core numerics of the port: binarization, BA-CAM scoring (the exact
integer path and the device model), two-stage top-k, paged attention,
the attention-backend registry and the energy/system simulator
(``core/energy.py``, imported on its own as in the reference)."""

from repro_torch.core.attention import (AttentionSpec, attention,
                                        dense_reference, make_mask)
from repro_torch.core.bacam import (CAM_H, CAM_W, bacam_scores,
                                    binary_scores_exact,
                                    hamming_scores_packed, pack_bits,
                                    unpack_bits)
from repro_torch.core.binarize import (binarize_qk, had_scales, sign_pm1,
                                       sign_ste)
from repro_torch.core.topk import (NEG_INF, hoeffding_drop_bound,
                                   single_stage_topk, topk_recall,
                                   two_stage_topk)

__all__ = [
    "AttentionSpec", "attention", "dense_reference", "make_mask",
    "CAM_H", "CAM_W", "bacam_scores", "binary_scores_exact",
    "hamming_scores_packed", "pack_bits", "unpack_bits",
    "binarize_qk", "had_scales", "sign_pm1", "sign_ste",
    "NEG_INF", "hoeffding_drop_bound", "single_stage_topk",
    "topk_recall", "two_stage_topk",
]
