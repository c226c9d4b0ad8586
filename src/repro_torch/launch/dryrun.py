"""Dry run over the production mesh: one call of every (arch x shape x
mesh) cell's step, on the host, without a card and without a compiler.

The reference lowers and compiles each cell's jitted step on 512
placeholder host devices and reads XLA's memory and cost analyses and
its optimized HLO.  The port has no compiled program, so it runs the
step itself, once, as one device of the mesh would:

  * this process joins torch's ``fake`` process group as rank 0 of the
    production mesh's 256 (``--multi-pod``: 512) ranks, and
    ``launch/mesh.make_production_mesh`` builds the live ``DeviceMesh``;
  * every argument is rank 0's block (params, and m / v in training,
    the batch's rows, the caches) on the meta device: shapes and dtypes,
    no memory (the train step's count is a host tensor, as always);
  * the cell's step runs once: the sharded train step
    (``make_train_step(mesh=)``), or the sharded prefill / serve step
    (``make_prefill_step(mesh=)`` / ``make_serve_step(mesh=)``); the
    collectives go to the fake group, which moves nothing, and every
    kernel wrapper takes its plain version (the tensors are not CUDA
    tensors), so the operations are the card's minus the kernels'
    internals;
  * ``utils/hlo.analyze_step`` counts its per-device FLOPs, dot bytes
    and collective bytes, ``launch/analysis.roofline_terms`` turns them
    into H100 roofline terms, and ``MemTracker`` reads the peak of live
    tensor bytes.

Each cell writes ``<out-dir>/<arch>_<shape>_<pod|multipod>[_tag].json``
(default ``results/dryrun_torch/``).  The numbers are derived on the
host from H100 data-sheet constants; none is measured on a card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      mistral-nemo-12b --shape decode_32k [--multi-pod] [--backend B] \\
      [--profile tp|dp] [--dist-topk] [--prefill-chunk N] [--all]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table  # records
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config
from repro_torch.launch import analysis
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model_def
from repro_torch.models.transformer import dtype_of
from repro_torch.sharding import partitioning as P
from repro_torch.utils.hlo import analyze_step
from repro_torch.utils.io import write_json_atomic

__all__ = ["RESULTS_DIR", "ATTENTION_FAMILIES", "effective_config",
           "fake_world", "build_cell", "argument_bytes", "run_cell", "table",
           "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__),
                           "../../../results/dryrun_torch")

# Full-attention archs skip *dense* long_500k (quadratic-prefill
# families) but run it with the paper's technique: the binary packed-K
# cache and the top-32 sparse V gather make 500k decode tractable.
ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


def effective_config(arch: str, shape: str, backend: str | None,
                     dist_topk: bool = False, prefill_chunk: int = 0):
    cfg = get_config(arch)
    if dist_topk:
        cfg = cfg.replace(distributed_topk=True)
    if prefill_chunk:
        cfg = cfg.replace(prefill_chunk=prefill_chunk)
    note = ""
    if backend:
        cfg = cfg.replace(attn_backend=backend)
        note = f"backend={backend} (CLI)"
    elif shape == "long_500k" and cfg.family in ATTENTION_FAMILIES:
        cfg = cfg.replace(attn_backend="camformer")
        note = ("dense long_500k skipped (full attention); run with "
                "CAMformer binary top-k cache per paper Sec. IV-C")
    return cfg, note


def fake_world(world: int) -> None:
    """Make this process rank 0 of a ``world``-process ``fake`` group
    (collectives complete at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_shape(shape, spec, sizes) -> tuple:
    """A block's shape: each dim over the product of its entry's axes."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _arguments(md, cfg, shape: str, mesh) -> list:
    """[(name, global shape, dtype, spec)] of every argument leaf of the
    cell's step: the train state (float32 params, m, v; the int32 step)
    and batch, or the served weights (compute type), the batch and the
    caches."""
    kind = SHAPES[shape]["kind"]
    sh = SHAPES[shape]
    out = []
    add = lambda name, tree, specs, dtype=None: S.map_specs(
        lambda leaf, spec: out.append(
            (name,) + ((tuple(leaf), dtype) if dtype is not None
                       else (tuple(leaf[0]), leaf[1])) + (tuple(spec),)),
        tree, specs)
    if kind == "train":
        shapes, specs = S.state_specs(md, cfg, mesh)
        for key in ("params", "m", "v"):
            tree = shapes["params"] if key == "params" else \
                shapes["opt"][key]
            spec = specs["params"] if key == "params" else specs["opt"][key]
            add(key, tree, spec, torch.float32)
        out.append(("step", (), torch.int32, ()))
    else:
        shapes, specs = S.params_specs(md, cfg, mesh, serve=True)
        add("params", shapes, specs, dtype_of(cfg))
    b_specs, b_axes = S.batch_specs(cfg, shape, mesh,
                                    serve=kind == "decode")
    for name in b_specs:
        out.append(("batch", tuple(b_specs[name][0]), b_specs[name][1],
                    tuple(b_axes[name])))
    if kind != "train":
        tree, specs = S.cache_specs_trees(md, cfg, sh["global_batch"],
                                          sh["seq_len"], mesh)
        add("caches", tree, specs)
    return out


def argument_bytes(md, cfg, shape: str, mesh) -> int:
    """Per-device bytes of the cell's arguments: each leaf's block under
    its spec (spec arithmetic; ``mesh`` a live mesh or a ``MeshShape``)."""
    sizes = P.axis_sizes(mesh)
    return sum(math.prod(_local_shape(s, spec, sizes))
               * torch.empty((), dtype=dt).element_size()
               for _, s, dt, spec in _arguments(md, cfg, shape, mesh))


def _block_tree(tree, specs, mesh, dtype=None):
    """DTensors of this process's zero blocks of a (shape[, dtype]) tree."""
    from torch.distributed.tensor import DTensor

    sizes = P.axis_sizes(mesh)

    def block(leaf, spec):
        shape, dt = (tuple(leaf), dtype) if dtype is not None else \
            (tuple(leaf[0]), leaf[1])
        return DTensor.from_local(
            torch.zeros(_local_shape(shape, spec, sizes), dtype=dt), mesh,
            P.placements(spec, mesh), run_check=False,
            shape=torch.Size(shape), stride=S._contiguous_stride(shape))

    return S.map_specs(block, tree, specs)


def build_cell(arch: str, shape: str, mesh, backend: str | None,
               dist_topk: bool = False, prefill_chunk: int = 0, *,
               config=None):
    """(cfg, md, step, args, n_params, note) of a cell on the live
    ``mesh``: the sharded step and this process's blocks of its
    arguments, on the default device (under ``torch.device("meta")`` no
    memory is held).
    ``config`` replaces the arch's effective config (a reduced one)."""
    cfg, note = effective_config(arch, shape, backend, dist_topk,
                                 prefill_chunk)
    if config is not None:
        cfg, note = config, "config given"
    md = get_model_def(cfg)
    kind = SHAPES[shape]["kind"]
    sh = SHAPES[shape]
    n_params = sum(math.prod(leaf[0]) for leaf in _param_leaves(md, cfg))
    sizes = P.axis_sizes(mesh)
    b_specs, b_axes = S.batch_specs(cfg, shape, mesh,
                                    serve=kind == "decode")
    batch = {k: torch.zeros(_local_shape(b_specs[k][0], b_axes[k], sizes),
                            dtype=b_specs[k][1]) for k in b_specs}
    if kind == "train":
        step, _ = S.make_train_step(md, cfg, mesh=mesh)
        shapes, specs = S.state_specs(md, cfg, mesh)
        params = _block_tree(shapes["params"], specs["params"], mesh,
                             torch.float32)
        state = {"params": params,
                 "opt": {"m": _block_tree(shapes["params"], specs["params"],
                                          mesh, torch.float32),
                         "v": _block_tree(shapes["params"], specs["params"],
                                          mesh, torch.float32),
                         "step": torch.zeros((), dtype=torch.int32,
                                             device="cpu")}}
        return cfg, md, step, (state, batch), n_params, note
    shapes, specs = S.params_specs(md, cfg, mesh, serve=True)
    params = _block_tree(shapes, specs, mesh, dtype_of(cfg))
    tree, cspecs = S.cache_specs_trees(md, cfg, sh["global_batch"],
                                       sh["seq_len"], mesh)
    caches = _block_tree(tree, cspecs, mesh)
    if kind == "prefill":
        return (cfg, md, S.make_prefill_step(md, cfg, mesh=mesh),
                (params, batch, caches), n_params, note)
    return (cfg, md, S.make_serve_step(md, cfg, mesh=mesh),
            (params, batch["tokens"], batch["pos"], batch["kv_len"],
             caches), n_params, note)


def _param_leaves(md, cfg) -> list:
    leaves = []
    S.map_specs(leaves.append, md.shapes(cfg))
    return leaves


def _local_bytes(tree) -> int:
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _peak_bytes(fn):
    """(fn's value, the peak of live tensor bytes inside it, or None and
    the reason when the tracker cannot run there)."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker

        tracker = MemTracker()
        with tracker:
            value = fn()
        snap = tracker.get_tracker_snapshot("peak")
        return value, max(v.get("Total", 0) for v in snap.values()), ""
    except Exception as e:  # noqa: BLE001 — recorded in the cell's note
        return None, None, f"MemTracker: {type(e).__name__}: {e}"


def run_cell(arch: str, shape: str, *, multi_pod: bool, backend=None,
             out_dir=RESULTS_DIR, tag="", dist_topk=False, prefill_chunk=0):
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size()
    stats = {}

    def once():
        cfg, md, fn, args, n_params, note = build_cell(
            arch, shape, mesh, backend, dist_topk, prefill_chunk)
        t0 = time.time()
        _, st = analyze_step(fn, *args)
        stats.update(st, trace_s=time.time() - t0, cfg=cfg, md=md,
                     n_params=n_params, note=note,
                     arg_bytes=_local_bytes(args))

    with torch.device("meta"):
        _, peak, why = _peak_bytes(once)
        if not stats:  # the tracker failed before the step ran: run bare
            once()
    cfg, n_params = stats["cfg"], stats["n_params"]
    note = "; ".join(x for x in (stats["note"], why) if x)
    roof = analysis.roofline_terms(stats, cfg, shape, n_params, chips)
    print(f"[{arch} x {shape} x {'multipod' if multi_pod else 'pod'}] "
          f"trace {stats['trace_s']:.1f}s")
    rec = {
        "arch": arch, "shape": shape, "kind": SHAPES[shape]["kind"],
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "backend": cfg.backend, "note": note, "tag": tag,
        "profile": P.get_parallelism_profile(), "n_params": n_params,
        "trace_s": round(stats["trace_s"], 1),
        "memory": {"argument_bytes": stats["arg_bytes"],
                   "peak_bytes": peak},
        "counted": {
            "flops_per_device": stats["flops"],
            "dot_bytes_per_device": stats["dot_bytes"],
            "collective_bytes_per_device": stats["collective_bytes"],
            "collectives": stats["collectives"],
        },
        "roofline": roof,
    }
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}_{shape}_{'multipod' if multi_pod else 'pod'}"
    name += f"_{tag}" if tag else ""
    write_json_atomic(os.path.join(out_dir, name + ".json"), rec)
    print(f"  roofline: compute {roof['compute_s']:.3e}s | memory "
          f"{roof['memory_s']:.3e}s | collective {roof['collective_s']:.3e}s "
          f"-> {roof['dominant']}-bound, roofline fraction "
          f"{roof['roofline_fraction']:.3f}")
    return rec


def table(out_dir=RESULTS_DIR, mesh: str = "pod", tag: str = "") -> str:
    """A markdown table of the records in ``out_dir`` on ``mesh`` ("pod"
    or "multipod"), one row a cell in ``ASSIGNED_ARCHS`` x ``SHAPES``
    order: per-device argument and peak GB, counted TFLOP, collective
    GB, the three roofline terms, the dominant one and the trace s (a
    cell without a record reads "no record")."""
    import json

    rows = ["| arch | shape | argument GB | peak GB | TFLOP | collective "
            "GB | compute s | memory s | collective s | dominant | trace s "
            "|", "|" + "---|" * 11]
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            name = f"{arch}_{shape}_{mesh}" + (f"_{tag}" if tag else "")
            path = os.path.join(out_dir, name + ".json")
            if not os.path.exists(path):
                rows.append(f"| {arch} | {shape} |" + " no record |" * 9)
                continue
            with open(path) as f:
                r = json.load(f)
            mem, cnt, roof = r["memory"], r["counted"], r["roofline"]
            peak = ("null" if mem["peak_bytes"] is None
                    else f"{mem['peak_bytes'] / 1e9:.3f}")
            rows.append(
                f"| {arch} | {shape} | {mem['argument_bytes'] / 1e9:.3f} | "
                f"{peak} | {cnt['flops_per_device'] / 1e12:.4g} | "
                f"{cnt['collective_bytes_per_device'] / 1e9:.4g} | "
                f"{roof['compute_s']:.3e} | {roof['memory_s']:.3e} | "
                f"{roof['collective_s']:.3e} | {roof['dominant']} | "
                f"{r['trace_s']} |")
    return "\n".join(rows)


def main(argv=None):
    from repro_torch.launch.cli import resolve_backend_arg

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--backend", default=None,
                    choices=[None, "dense", "binary", "camformer"],
                    help="attention backend (uniform over the stack)")
    ap.add_argument("--attn-mode", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", default="tp", choices=["tp", "dp"],
                    help="sharding profile (see sharding/partitioning.py)")
    ap.add_argument("--dist-topk", action="store_true",
                    help="distributed two-stage CAM search")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (tokens per chunk; 0 = whole-seq)")
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) cell")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out-dir as a markdown "
                         "table and exit")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out_dir, "multipod" if args.multi_pod else "pod",
                    args.tag))
        return

    P.set_parallelism_profile(args.profile)
    backend = resolve_backend_arg(args)
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES:
                try:
                    run_cell(arch, shape, multi_pod=args.multi_pod,
                             backend=backend, out_dir=args.out_dir,
                             tag=args.tag)
                except Exception as e:  # noqa: BLE001 — report, continue
                    print(f"[{arch} x {shape}] FAILED: "
                          f"{type(e).__name__}: {e}")
        return
    run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
             backend=backend, out_dir=args.out_dir, tag=args.tag,
             dist_topk=args.dist_topk, prefill_chunk=args.prefill_chunk)


if __name__ == "__main__":
    main()
