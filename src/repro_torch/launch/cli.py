"""Shared CLI plumbing for the launch drivers: ``--backend`` (a
core/backend.py registry name) and ``--layer-backends`` (a per-layer
policy cycled over the stack)."""

from __future__ import annotations

import argparse

__all__ = ["add_backend_args", "apply_backend_args"]


def add_backend_args(ap: argparse.ArgumentParser):
    ap.add_argument("--backend", default=None,
                    help="attention backend (core/backend.py registry: "
                         "dense | binary | camformer | hybrid)")
    ap.add_argument("--layer-backends", default=None,
                    help="comma-separated per-layer backend policy, "
                         "cycled over the stack (e.g. dense,camformer)")


def apply_backend_args(cfg, args):
    if args.backend:
        cfg = cfg.replace(attn_backend=args.backend)
    if args.layer_backends:
        cfg = cfg.replace(
            layer_backends=tuple(args.layer_backends.split(",")))
    return cfg
