"""End-to-end training from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch camformer-bert \\
        --smoke --steps 4 --device cpu

Without ``--device cpu`` it trains on the card.  ``--smoke`` takes the
reduced config and a batch of 8 x 128 tokens; without it the config
trains at full width on ``--shape`` (default ``train_4k``).  The
reference's mesh flags (``--devices``, ``--model-parallel``,
``--production-mesh``, ``--multi-pod``) have no counterpart: the port
trains on one device.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.launch.cli import add_backend_args, apply_backend_args
from repro_torch.models import get_model_def
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    add_backend_args(ap)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_backend_args(cfg, args)
    md = get_model_def(cfg)
    shape = args.shape
    if args.smoke:
        SHAPES["smoke"] = dict(seq_len=128, global_batch=8, kind="train")
        shape = "smoke"

    data = SyntheticLMData(cfg, shape, device=args.device)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(md, cfg, data, tcfg, device=args.device)
    trainer.run()
    for row in trainer.metrics_log:
        print(row)
    for ev in trainer.events:
        print("event:", ev)


if __name__ == "__main__":
    main()
