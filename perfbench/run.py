"""The benchmark of ``repro_torch`` serving on one H100.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration (``perfbench/configs/``), traffic mix
(``perfbench/traffic/``) and metrics (``perfbench/metrics/``); the
limits that decide ``correct`` are in ``perfbench/limits/``.  With
``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
device-only profile of the same window.  The numbers compared for
``correct`` and their limits end standard error and the result line.

Exits non-zero with no result line when the card is missing, when the
program cannot be imported, or when ``jax``, ``jaxlib``, ``flax`` or the
JAX package (``repro``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's CUDA kernels build into ``build/`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _pcts(values, qs=(50, 80, 90)):
    from yardstick.stats import percentile

    return [percentile(values, q) for q in qs]


def main(argv=None, *, device: str = "cuda", root: Path = ROOT) -> int:
    """The command; ``device`` and ``root`` are for the CPU tests, which
    run a smoke-size copy of the benchmark's files on the CPU."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    for i, p in enumerate((HERE, ROOT / "src")):
        if str(p) not in sys.path:
            sys.path.insert(i, str(p))
    import torch

    from yardstick import cell, check, registry
    bench = registry.load_benchmark(root)
    wl = registry.workload(bench, args.workload)
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < wl["chips"]):
        print(f"needs {wl['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    limits = registry.limits(args.workload, root / "perfbench")
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_proc0=T_PROC0, device=device, root=root, bench=bench)
    found = cell.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 5
    verdict = check.judge(out, limits, args.seed)
    del out["params"], out["capture"]
    rec = out["record"]
    metrics = {}
    for m in registry.metrics_for(bench, args.workload, bool(args.trace)):
        val = registry.metric_reader(m["name"], root / "perfbench")(rec)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    info = out["device"]
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info}
    if args.trace:
        tr = rec["trace"]
        info["busy_s"] = tr["busy_s"] if tr else None
        info["window_s"] = rec["loop_s"]
        if tr:
            from yardstick.trace import breakdown
            result["breakdown"] = breakdown(tr)
    result["check"] = verdict["checks"]
    found = cell.forbidden_modules()
    if found:
        print(f"loaded after the window: {found}", file=sys.stderr)
        return 5
    print(f"set-up phases (s from process start): {rec['setup_phases']}",
          file=sys.stderr)
    print(f"window: {rec['tokens']} tokens, {len(rec['ttft_s'])} requests "
          f"submitted; ttft s p50/p80/p90 {_pcts(rec['ttft_s'])}; tpot s "
          f"p50/p80/p90/p95 {_pcts(rec['tpot_s'], (50, 80, 90, 95))}",
          file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
