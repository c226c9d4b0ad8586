"""Readings behind a cell's limits, many seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 [--bare-seeds 11] --seconds <s> \
        --out <file.json>

For every seed: a run of the cell as ``run.py`` makes it (weights, engine,
warm-up and traffic drawn from the seed, the window, the sample), then
the program's compared numbers against the float32 reference (the lower
readings of ``perfbench/limits/<cell>.json``), with other percentiles
and each layer's beside them.  For the control seeds also the float8
control's numbers over the same positions (the upper readings).  A bare
seed runs once more right after its run, without the check's recording,
so that the two windows show what the recording costs.  The benchmark's
own runs never run this; it needs the card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _window(rec) -> dict:
    """The end-to-end numbers of a window (untraced run's)."""
    from yardstick.stats import percentile

    return dict(tokens=rec["tokens"],
                tokens_per_s=rec["tokens"] / rec["window_s"],
                requests=len(rec["ttft_s"]),
                ttft_p90_s=percentile(rec["ttft_s"], 90),
                tpot_p95_s=percentile(rec["tpot_s"], 95),
                ticks=rec["counters"]["ticks"],
                prefill_ticks=rec["counters"]["prefill_ticks"])


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--bare-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT / "src"))
    import run as entry

    entry._caches()
    import torch

    from yardstick import cell, check

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    bare = {int(s) for s in args.bare_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.run(args.workload, seed, args.seconds, False, t_proc0=t0,
                       root=ROOT)
        picked = check.sample(out["finished"], seed,
                              out["traffic"]["check_tokens"])
        rec = out["record"]
        row = dict(seed=seed, requests=len(picked),
                   tokens=sum(len(s) for _, _, s in picked),
                   failed=out["failed"], tick_errors=rec["tick_errors"],
                   setup_s=rec["setup_s"], phases=rec["setup_phases"],
                   peak=out["peak"])
        t1 = time.perf_counter()
        cap = out["capture"].states(
            [(rid, len(p) + len(s) - 1, len(s)) for rid, p, s in picked])
        row["program"] = check.program_numbers(
            out["cfg_numbers"], out["params"], picked, cap, diag=True)
        del cap
        row["reference_s"] = time.perf_counter() - t1
        if seed in controls:
            row["control"] = check.control_numbers(
                out["cfg_numbers"], out["params"], picked, diag=True)
        row["run_s"] = time.perf_counter() - t0
        row["window"] = _window(rec)
        rows.append(row)
        print(json.dumps(row), flush=True)
        out["capture"] = None
        del out, picked
        _free(torch)
        if seed in bare:
            t0 = time.perf_counter()
            out = cell.run(args.workload, seed, args.seconds, False,
                           t_proc0=t0, root=ROOT, record=False)
            rec = out["record"]
            row = dict(seed=seed, bare=True, setup_s=rec["setup_s"],
                       peak=out["peak"], window=_window(rec))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del out
            _free(torch)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        dict(workload=args.workload, seconds=args.seconds,
             card=torch.cuda.get_device_name(0),
             power_limit=cell._power_limit(), rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
