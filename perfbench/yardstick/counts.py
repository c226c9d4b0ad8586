"""Operation and byte counts, and the card's published peaks.

Frozen here so that a change to the program cannot move the yardstick:

* ``step_flops``: the FLOPs a window's tokens need, written out from the
  configuration's shapes (``launch/analysis.py`` counted them on fake
  tensors; this is its idea with the numerator written out again).
  Weight matmuls for every prefilled and decoded token, vocabulary logits
  only where a token is sampled, and CAMformer's sparse contextualization
  (k_top V rows a query head).  Binary CAM scoring is integer work and
  counts no FLOPs; the norms, RoPE and softmax are left out as small.
* ``stage1_bytes``: the bytes one launch of the paged BA-CAM stage-1
  kernel (``bacam_paged_topk_stage1``, kernel 1) needs, each input read
  once and each output written once: a frozen copy of ``chip_smoke.py``'s
  kernel-1 row count (q, the live packed keys of every kv head, the page
  table, kv_len and q_pos, both candidate outputs).

Peaks: one NVIDIA H100 SXM, data sheet, dense rates at 700 W.
"""

from __future__ import annotations

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def weight_flops_per_token(m: dict) -> float:
    """2 x the weight elements a token multiplies through every layer
    (q, k, v, o projections and the gated FFN), excluding the head."""
    d, hd = m["d_model"], m["head_dim"]
    q = m["n_heads"] * hd
    kv = m["n_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    ffn = 3 * d * m["d_ff"]
    return 2.0 * m["n_layers"] * (attn + ffn)


def context_flops_per_token(m: dict) -> float:
    """CAMformer's sparse contextualization: each query head weighs
    k_top value rows of head_dim (a multiply and an add each)."""
    return 2.0 * m["n_layers"] * m["n_heads"] * m["k_top"] * m["head_dim"]


def logits_flops(m: dict) -> float:
    """The vocabulary head for one sampled token."""
    return 2.0 * m["d_model"] * m["vocab"]


def step_flops(m: dict, prefill_tokens: int, decode_tokens: int,
               sampled: int) -> float:
    """FLOPs of ``prefill_tokens`` prompt positions, ``decode_tokens``
    decode positions and ``sampled`` vocabulary rows."""
    per_tok = weight_flops_per_token(m) + context_flops_per_token(m)
    return (per_tok * (prefill_tokens + decode_tokens)
            + logits_flops(m) * sampled)


def stage1_bytes(b: int, hkv: int, rows: int, words: int, np_: int,
                 page: int, group: int, stage1_k: int,
                 live_keys: int) -> int:
    """Bytes one kernel-1 launch needs: q (B, H_kv, R, W) int32, the
    ``live_keys`` packed keys (summed over the batch rows) of every kv
    head, the (B, NP) page table, kv_len and q_pos (B,) each, and the two
    (B, H_kv, R, ncand) int32 outputs."""
    ncand = stage1_k * (page // group) * np_
    return (b * hkv * rows * words * 4 + live_keys * hkv * words * 4
            + b * np_ * 4 + 2 * b * 4 + 2 * b * hkv * rows * ncand * 4)
