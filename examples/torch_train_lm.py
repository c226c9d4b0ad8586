"""End-to-end training driver of the port: train a ~100M-parameter LM
with the full substrate (seeded data pipeline, AdamW, async
checkpointing, fault-tolerant trainer).  The port of
``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
trains the ~125M default config on the card; ``--tiny`` takes a ~2M
parameter model through the same code path:
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --steps 60 \\
        --device cpu

Runs on one device, the card unless ``--device cpu`` is given (there is
no fallback: without a card the default raises).  The reference builds
a device mesh (``launch/mesh.make_mesh_for``); the port has none yet and
trains on that one device.
"""

import argparse
import os
import tempfile

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.cli import add_backend_args, apply_backend_args
from repro_torch.models import get_model_def
from repro_torch.models.module import param_shapes
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainerConfig


def lm_100m():
    return ModelConfig(
        name="lm-125m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=8192,
        dtype="float32",
    )


def lm_tiny():
    return ModelConfig(
        name="lm-tiny", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        dtype="float32", k_top=8, group_size=4,
    )


def n_params(cfg):
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        n = 1
        for dim in node[0]:
            n *= dim
        return n

    return count(param_shapes(cfg))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    add_backend_args(ap)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = apply_backend_args(lm_tiny() if args.tiny else lm_100m(), args)
    seq = args.seq or (128 if args.tiny else 1024)
    batch = args.batch or (8 if args.tiny else 64)
    SHAPES["e2e"] = dict(seq_len=seq, global_batch=batch, kind="train")

    md = get_model_def(cfg)
    print(f"model: {cfg.name}  params={n_params(cfg):,}  "
          f"attn={cfg.uniform_backend or ','.join(cfg.backend_names)}  "
          f"seq={seq} batch={batch}  device={args.device}")
    data = SyntheticLMData(cfg, "e2e", device=args.device)
    tcfg = TrainerConfig(total_steps=args.steps,
                         ckpt_every=max(10, args.steps // 4),
                         log_every=max(1, args.steps // 15),
                         ckpt_dir=args.ckpt_dir, peak_lr=1e-3,
                         warmup=args.steps // 10)
    trainer = Trainer(md, cfg, data, tcfg, device=args.device)
    trainer.run()
    print(f"{'step':>6s} {'loss':>9s} {'lr':>9s} {'gnorm':>8s} {'s/step':>7s}")
    for row in trainer.metrics_log:
        print(f"{row['step']:6d} {row['loss']:9.4f} {row['lr']:9.2e} "
              f"{row['grad_norm']:8.2f} {row['step_time_s']:7.3f}")
    for ev in trainer.events:
        print("event:", ev)
    first, last = trainer.metrics_log[0]["loss"], trainer.metrics_log[-1]["loss"]
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'no improvement'})")


if __name__ == "__main__":
    main()
