"""Shared CLI plumbing for the launchers.

Backend selection is one flag set across serve/gateway/train:
``--backend`` (a core/backend.py registry name) plus ``--layer-backends``
for the per-layer policy.  ``--attn-mode`` is removed, as in the
reference; the flag is still parsed (hidden) so stale scripts fail with
a clear migration error instead of argparse's generic
unrecognized-argument one.  ``add_engine_args`` and ``build_engine``
are the serving flags and the engine they build, shared by
``launch/serve.py`` and ``launch/gateway.py``.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config, smoke_config
from repro_torch.models import init_params
from repro_torch.models.transformer import dtype_of
from repro_torch.serving import ServeEngine, parse_faults

__all__ = ["add_backend_args", "add_engine_args", "apply_backend_args",
           "build_engine", "resolve_backend_arg"]


def add_backend_args(ap: argparse.ArgumentParser):
    ap.add_argument("--backend", default=None,
                    help="attention backend (core/backend.py registry: "
                         "dense | binary | camformer | hybrid)")
    ap.add_argument("--attn-mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--layer-backends", default=None,
                    help="comma-separated per-layer backend policy, "
                         "cycled over the stack (e.g. dense,camformer)")


def resolve_backend_arg(args) -> str | None:
    """The requested backend name; stale --attn-mode usage is a clean
    error pointing at the migration."""
    if getattr(args, "attn_mode", None):
        raise SystemExit(
            f"--attn-mode was removed; use --backend {args.attn_mode} "
            "(or --layer-backends for a per-layer policy)")
    return args.backend


def apply_backend_args(cfg, args):
    backend = resolve_backend_arg(args)
    if backend:
        cfg = cfg.replace(attn_backend=backend)
    if args.layer_backends:
        cfg = cfg.replace(
            layer_backends=tuple(args.layer_backends.split(",")))
    return cfg


def build_engine(args) -> ServeEngine:
    """The engine ``launch/serve.py`` and ``launch/gateway.py`` serve
    from, built from their shared flags.  With ``--tp N > 1`` under
    ``torchrun`` (one process a device) this process joins the default
    group (NCCL on the card, gloo with ``--device cpu``) unless it has
    already; every process builds the same engine from the same seed,
    and rank 0 serves (``ServeEngine.follow`` on the others).  The
    weights are drawn at the config's compute dtype (``dtype_of``)."""
    if args.tp > 1 and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, make_tp_mesh

        if not dist.is_initialized():
            init_distributed(args.device)
        make_tp_mesh(args.tp)  # every process of the world, together
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_backend_args(cfg, args)
    if args.prefill_chunk is not None:
        cfg = cfg.replace(prefill_chunk=args.prefill_chunk)
    # drawn at the serving dtype leaf by leaf: the float32 tree of the
    # larger configs would not fit the card
    params = init_params(cfg, device=args.device, seed=args.seed,
                         dtype=dtype_of(cfg))
    faults = parse_faults(args.faults) if args.faults else None
    return ServeEngine(
        cfg,
        params,
        max_batch=args.max_batch,
        max_len=args.max_len,
        page_size=args.page_size,
        n_pages=args.n_pages,
        mode=args.mode,
        prefill_slice=args.prefill_slice,
        paged_impl=args.paged_impl,
        prefill_impl=args.prefill_impl,
        spec_k=args.spec_k,
        spec_backend=args.spec_backend,
        tp=args.tp,
        max_queue=args.max_queue,
        faults=faults,
        device=args.device,
    )


def add_engine_args(ap: argparse.ArgumentParser, *, max_batch: int,
                    max_len: int) -> None:
    """The flags ``build_engine`` reads, with the launcher's defaults for
    the two sizes."""
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    add_backend_args(ap)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--max-batch", type=int, default=max_batch)
    ap.add_argument("--max-len", type=int, default=max_len)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--n-pages", type=int, default=None,
                    help="page-pool size; default = full residency")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill chunk length (0 = whole prompt)")
    ap.add_argument("--mode", default="overlap", choices=("overlap", "sync"))
    ap.add_argument("--prefill-slice", type=int, default=None,
                    help="continuous batching: prefill joining prompts in "
                         "chunks of this many tokens across ticks")
    ap.add_argument("--paged-impl", default=None, choices=("fused", "gather"),
                    help="paged decode realization: fused CUDA kernels "
                         "(default) or the plain page-gather reference")
    ap.add_argument("--prefill-impl", default=None,
                    choices=("auto", "fused", "gather"),
                    help="Sq>1 chunk realization (chunked prefill / "
                         "speculative verify): 'auto' follows --paged-impl")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="self-speculative decoding: draft this many "
                         "tokens per tick with the --spec-backend stack "
                         "and verify them in one target pass (0 = off)")
    ap.add_argument("--spec-backend", default=None,
                    help="drafter attention backend (default binary)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: head-shard every page "
                         "pool over a tp-axis mesh of processes "
                         "(launch/mesh.py make_tp_mesh; run under torchrun "
                         "--nproc-per-node N) and gather the heads every "
                         "layer; 1 (default) is the single-process engine, "
                         "same code path, and any degree is token-for-"
                         "token identical to it")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: beyond this queue depth new "
                         "requests are refused (QueueFullError; HTTP 429 + "
                         "Retry-After at the gateway; default: unbounded)")
    ap.add_argument("--faults", default=None,
                    help="chaos fault plan, e.g. 'step.error@3,"
                         "kv.exhaust@1:4,tick.delay@0:20:p0.5:d0.01' "
                         "(serving/faults.py grammar; default: none)")
