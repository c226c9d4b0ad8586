"""Quickstart: CAMformer attention as a drop-in PyTorch operator, the
port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]

Runs on one device, the card unless ``--device cpu`` is given (there is
no fallback: without a card the default raises).  ``--batch`` and
``--seq`` cut the attention inputs (default 2 x 1024 tokens of 16 heads
of 64, BERT-Large's geometry).
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (AttentionSpec, attention, bacam_scores,
                              binary_scores_exact, dense_reference,
                              pack_bits, sign_pm1, single_stage_topk,
                              topk_recall, two_stage_topk)
from repro_torch.core.energy import table2_rows


def cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # --- 1. attention in three modes (Eq. 1 of the paper) ---------------
    b, h, s, d = args.batch, 16, args.seq, 64
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev)
               for _ in range(3))
    out_dense = dense_reference(q, k, v, causal=True)
    cam = AttentionSpec(mode="camformer", k_top=32, group_size=16,
                        stage1_k=2)
    for mode, spec in (("binary", AttentionSpec(mode="binary")),
                       ("camformer", cam)):
        out = attention(q, k, v, spec, causal=True)
        print(f"dense vs {mode} cosine: {cosine(out_dense, out):.4f}")
    # the same operator on the BA-CAM device model: a 6-bit SAR ADC and
    # 1.4% matchline noise per 64-bit tile, keyed by a raw key
    key = torch.tensor([0, 42], dtype=torch.int64, device=dev)
    out = attention(q, k, v, cam.replace(adc_bits=6, noise_sigma=0.014),
                    causal=True, rng=key)
    print(f"dense vs camformer (6-bit ADC, sigma 1.4%) cosine: "
          f"{cosine(out_dense, out):.4f}")

    # --- 2. the BA-CAM primitive: packed binary scores ------------------
    qb, kb = sign_pm1(q[0, 0, :4]), sign_pm1(k[0, 0])
    scores = bacam_scores(qb, kb)  # XNOR + popcount over packed words
    print("binary scores shape/range:", tuple(scores.shape),
          int(scores.min()), int(scores.max()),
          "| packed key bytes:", pack_bits(kb).numel() * 4, "vs bf16:",
          kb.numel() * 2)
    exact = binary_scores_exact(qb, kb)
    device = bacam_scores(qb, kb, exact=False, adc_bits=6,
                          noise_sigma=0.014, rng=key)
    n_top = min(32, kb.shape[0])
    recall = topk_recall(single_stage_topk(device, n_top)[1],
                         single_stage_topk(exact, n_top)[1])
    print(f"device model (6-bit ADC, sigma 1.4%): mean |score error| "
          f"{float((device - exact).abs().mean()):.3f}, recall@{n_top} "
          f"against exact {float(recall.mean()):.3f}")

    # --- 3. hierarchical two-stage top-k (top-2 per 16 -> top-32) --------
    sc = torch.randn((64, 1024), generator=gen, device=dev)
    _, ti = two_stage_topk(sc, k=32, group_size=16, stage1_k=2)
    _, si = single_stage_topk(sc, 32)
    print("two-stage recall@32:", float(topk_recall(ti, si).mean()))

    # --- 4. the paper's Table II row from the system simulator ----------
    row = table2_rows()["CAMformer (ours, simulated)"]
    print(f"CAMformer @1GHz: {row['thr_qry_ms']:.0f} qry/ms, "
          f"{row['eff_qry_mj']:.0f} qry/mJ, {row['area_mm2']:.2f} mm^2, "
          f"{row['power_w']:.2f} W")


if __name__ == "__main__":
    main()
