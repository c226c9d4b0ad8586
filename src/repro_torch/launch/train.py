"""End-to-end training from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch camformer-bert \\
        --smoke --steps 4 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch camformer-bert --smoke --steps 4 --devices 4 \\
        --model-parallel 2 --device cpu

Without ``--device cpu`` it trains on the card.  ``--smoke`` takes the
reduced config and a batch of max(8, data-axis size) x 128 tokens;
without it the config trains at full width on ``--shape`` (default
``train_4k``).  Under ``torchrun`` (or with a process group already
initialised) it trains sharded: the group's backend follows
``--device`` (NCCL on the card, gloo on the CPU), the mesh is
``--devices`` (default: the world) x ``--model-parallel``, or the
production mesh (``--production-mesh`` [``--multi-pod``]) when the world
is that large, and it becomes the ambient mesh.  Without ``torchrun``
and with ``--devices`` 0 or 1 it trains on one device, unsharded.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config, smoke_config
from repro_torch.launch.cli import add_backend_args, apply_backend_args
from repro_torch.launch.mesh import (init_distributed, make_mesh_for,
                                     make_production_mesh, set_mesh)
from repro_torch.models import get_model_def
from repro_torch.train.data import SyntheticLMData
from repro_torch.train.trainer import Trainer, TrainerConfig


def _mesh(args):
    """(mesh or None, device) for the flags (see the module doc)."""
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        if args.devices > 1 or args.production_mesh:
            raise ValueError(
                f"--devices {args.devices}"
                f"{' --production-mesh' if args.production_mesh else ''} "
                f"needs one process per device: run under torchrun "
                f"--nproc-per-node N")
        return None, args.device
    device = init_distributed(args.device)
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        if not hasattr(mesh, "mesh_dim_names"):
            raise ValueError(f"--production-mesh needs {mesh.size} "
                             f"processes, the world has "
                             f"{dist.get_world_size()}")
    else:
        mesh = make_mesh_for(args.devices or dist.get_world_size(),
                             args.model_parallel)
    return mesh, device


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
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    add_backend_args(ap)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_backend_args(cfg, args)
    owns_group = not dist.is_initialized()
    mesh, device = _mesh(args)
    set_mesh(mesh)
    try:
        return _train(args, cfg, mesh, device)
    finally:
        set_mesh(None)
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, mesh, device):
    md = get_model_def(cfg)
    shape = args.shape
    if args.smoke:
        data_ax = dict(zip(mesh.mesh_dim_names, mesh.shape)).get(
            "data", 1) if mesh is not None else 1
        SHAPES["smoke"] = dict(seq_len=128, global_batch=max(8, data_ax),
                               kind="train")
        shape = "smoke"

    data = SyntheticLMData(cfg, shape, device=device, mesh=mesh)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(md, cfg, data, tcfg, device=device, mesh=mesh)
    trainer.run()
    for row in trainer.metrics_log:
        print(row)
    for ev in trainer.events:
        print("event:", ev)
    return trainer


if __name__ == "__main__":
    main()
