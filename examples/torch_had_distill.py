"""Hamming Attention Distillation (HAD), the paper's accuracy foundation,
in the port.  The port of ``examples/had_distill.py``.

Trains a small dense teacher, then distills a binarized-Q/K student
(straight-through sign) on the same task loss; shows the binary student
recovering toward the teacher, and that switching the distilled student
from single-stage to the paper's two-stage top-k costs about nothing
(the Tables III/IV mechanism).

    PYTHONPATH=src python examples/torch_had_distill.py [--device cuda]

Runs on one device, the card unless ``--device cpu`` is given (there is
no fallback: without a card the default raises).  The reference builds
a one-device mesh (``launch/mesh.make_mesh_for``); the port has none
yet.  ``--teacher-steps`` and ``--student-steps`` cut the training
(default 80 and 40), ``--seq`` and ``--batch`` its batches (default
8 x 128 tokens).
"""

import argparse

import torch

from repro_torch.configs import SHAPES, smoke_config
from repro_torch.launch.steps import make_value_and_grad
from repro_torch.models import get_model_def, init_params
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.optimizer import adamw, constant_schedule


def train(cfg, params, data, steps, lr=1e-3, start_step=0):
    opt = adamw(constant_schedule(lr))
    state = opt.init(params)
    value_and_grad = make_value_and_grad(get_model_def(cfg), cfg)
    loss = None
    for i in range(steps):
        loss, _, grads = value_and_grad(params, data.batch(start_step + i))
        params, state, _ = opt.update(grads, state, params)
    return params, float(loss)


def eval_ce(cfg, params, data, n=4):
    md = get_model_def(cfg)
    with torch.no_grad():
        return sum(float(md.loss(params, data.batch(5000 + i), cfg)[1]["ce"])
                   for i in range(n)) / n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--teacher-steps", type=int, default=80)
    ap.add_argument("--student-steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    SHAPES["had"] = dict(seq_len=args.seq, global_batch=args.batch,
                         kind="train")
    base = smoke_config("codeqwen1.5-7b", d_model=128, n_layers=2, n_heads=4,
                        n_kv_heads=4, head_dim=32, vocab=512, k_top=16,
                        group_size=8)
    data = SyntheticLMData(base, "had", seed=0, device=args.device)
    params = init_params(base, device=args.device, seed=0)

    print(f"1) train dense teacher ({args.teacher_steps} steps)...")
    params, _ = train(base, params, data, steps=args.teacher_steps)
    ce_teacher = eval_ce(base, params, data)

    bin_cfg = base.replace(attn_backend="binary")
    ce_binary_0 = eval_ce(bin_cfg, params, data)

    print("2) HAD fine-tune: binarized Q/K student w/ straight-through sign "
          f"({args.student_steps} steps)...")
    student, _ = train(bin_cfg, params, data, steps=args.student_steps,
                       lr=5e-4, start_step=args.teacher_steps)
    ce_binary_had = eval_ce(bin_cfg, student, data)

    cam1 = bin_cfg.replace(attn_backend="camformer", stage1_k=8)  # 1-stage
    cam2 = bin_cfg.replace(attn_backend="camformer", stage1_k=2)  # paper
    ce_cam1 = eval_ce(cam1, student, data)
    ce_cam2 = eval_ce(cam2, student, data)

    print(f"\n{'config':44s} {'eval CE':>8s}")
    print(f"{'dense teacher':44s} {ce_teacher:8.4f}")
    print(f"{'binary Q/K, zero-shot (no distillation)':44s} "
          f"{ce_binary_0:8.4f}")
    print(f"{'binary Q/K after HAD fine-tune':44s} {ce_binary_had:8.4f}")
    print(f"{'HAD student + single-stage top-k':44s} {ce_cam1:8.4f}")
    print(f"{'HAD student + two-stage top-2/grp (paper)':44s} {ce_cam2:8.4f}")
    gap = max(ce_binary_0 - ce_teacher, 1e-9)
    print(f"\nHAD recovers {100 * (ce_binary_0 - ce_binary_had) / gap:.0f}% "
          f"of the binarization gap; two-stage costs "
          f"{ce_cam2 - ce_cam1:+.4f} CE vs single-stage (paper: ~0).")


if __name__ == "__main__":
    main()
