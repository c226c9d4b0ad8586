"""Roofline terms of a dry-run cell (the reference's arithmetic), with
NVIDIA H100 SXM data-sheet constants in place of the reference's TPU
v5e ones:

  989 TFLOP/s dense bf16 tensor-core peak, 3.35 TB/s HBM3, and 50 GB/s
  a link: one 400 Gb/s NDR InfiniBand port a GPU, because a 16-wide
  ``model`` axis spans two 8-GPU nodes (NVLink inside a node gives 450
  GB/s a direction, nine times that; a collective over the axis runs
  at its slowest link).

These are derived bounds on the host from data-sheet numbers, never a
measurement on a card.

Conventions (the counts of utils/hlo.py are PER DEVICE):
  compute term    = per_device_FLOPs / PEAK_FLOPS            [s]
  memory term     = per_device_dot_bytes / HBM_BW            [s]
  collective term = per_device_collective_bytes / LINK_BW    [s]

MODEL_FLOPS follows the reference: 6*N*D for training (N = active
params, D = global tokens), 2*N*D for inference passes.
"""

from __future__ import annotations

from repro_torch.configs.base import SHAPES

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM
HBM_BW = 3.35e12  # bytes/s, H100 SXM HBM3
LINK_BW = 50e9  # bytes/s: one 400 Gb/s NDR port a GPU (NVLink: 450e9)

__all__ = ["roofline_terms", "model_flops", "active_params",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]


def active_params(cfg, total_params: int) -> int:
    """Active parameter count (MoE: experts_per_token of n_experts)."""
    if not cfg.n_experts:
        return total_params
    per_expert = 3 * cfg.d_model * cfg.d_ff  # gated GLU expert
    all_expert = cfg.n_layers * cfg.n_experts * per_expert
    used_expert = cfg.n_layers * cfg.experts_per_token * per_expert
    return total_params - all_expert + used_expert


def model_flops(cfg, shape_name: str, total_params: int) -> float:
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    n_act = active_params(cfg, total_params)
    if sh["kind"] == "train":
        return 6.0 * n_act * b * s
    if sh["kind"] == "prefill":
        return 2.0 * n_act * b * s
    return 2.0 * n_act * b  # decode: one token a sequence a step


def roofline_terms(stats: dict, cfg, shape_name: str, total_params: int,
                   chips: int) -> dict:
    """The three terms, the dominant one and the model-FLOP ratios from a
    step's per-device counts (``utils/hlo.analyze_step``)."""
    per_dev_flops = stats["flops"]
    per_dev_bytes = stats["dot_bytes"]
    per_dev_coll = stats["collective_bytes"]
    terms = {"compute_s": per_dev_flops / PEAK_FLOPS,
             "memory_s": per_dev_bytes / HBM_BW,
             "collective_s": per_dev_coll / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_name, total_params)
    global_flops = per_dev_flops * chips
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_step_time_s": bound,
        "model_flops": mf,
        "hlo_flops_global": global_flops,
        "useful_flops_ratio": (mf / global_flops) if global_flops else 0.0,
        "roofline_fraction": ((mf / PEAK_FLOPS / chips) / bound
                              if bound > 0 else 0.0),
        "per_device": {"flops": per_dev_flops, "dot_bytes": per_dev_bytes,
                       "collective_bytes": per_dev_coll},
    }
