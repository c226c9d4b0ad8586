"""One seed of a cell three ways in one process: untraced, with the
program's spans on, and fully traced (the program's spans and the
device-only profile), each a ``cell.run`` as ``run.py`` makes it.

    python3 perfbench/program_trace.py --workload <cell> --seeds 11,12 \
        --seconds <s> [--modes off,spans,traced] [--out <file.json>]

For each run: the end-to-end numbers, ``correct`` by the cell's limits,
the five metrics that read the program's spans, stamps and
``prefill_positions`` (``metrics/attn.cam_device_share.py``,
``sched.prefill_live_share``, ``engine.dispatch_share``,
``sched.queue_wait_p90_s``, ``engine.first_token_lag_p90_s``) and the
``program_breakdown``.  The modes run in the given order on the first
seed, reversed on the second, and so on, so that no mode always runs
first.  The program record comes from ``yardstick.program.Window``,
installed around ``cell.run``; ``run.py`` does not read it.  On the CPU
(``--device cpu``, the tests' smoke checkout) a traced run has no
device profile, so ``attn.cam_device_share`` has nothing to read.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MODES = ("off", "spans", "traced")
METRICS = ("attn.cam_device_share", "sched.prefill_live_share",
           "engine.dispatch_share", "sched.queue_wait_p90_s",
           "engine.first_token_lag_p90_s")


def run_one(workload: str, seed: int, seconds: float, mode: str, *,
            root: Path = ROOT, device: str = "cuda") -> dict:
    from yardstick import cell, check, registry
    from yardstick.program import Window, program_breakdown
    from yardstick.stats import percentile

    t0 = time.perf_counter()
    win = Window(spans_on=mode != "off")
    with win.installed(cell):
        out = cell.run(workload, seed, seconds, mode == "traced",
                       t_proc0=t0, device=device, root=root)
    rec = win.finish(out["record"])
    verdict = check.judge(out, registry.limits(workload, root / "perfbench"),
                          seed)
    base = root / "perfbench"
    metrics = {}
    for name in METRICS:
        val = registry.metric_reader(name, base)(rec)
        if val is not None:
            metrics[name] = val
    tpot = percentile(rec["tpot_s"], 95)
    row = dict(seed=seed, mode=mode, correct=verdict["correct"],
               tokens=rec["tokens"],
               output_tokens_per_s=rec["tokens"] / rec["window_s"],
               ttft_p90_s=percentile(rec["ttft_s"], 90),
               tpot_p95_ms=None if tpot is None else tpot * 1e3,
               setup_s=rec["setup_s"], loop_s=rec["loop_s"],
               counters=rec["counters"], metrics=metrics,
               peak=out["peak"], device=out["device"])
    tr = rec["trace"]
    if tr:
        row["busy_s"] = tr["busy_s"]
        row["by_name_s"] = sum(tr["by_name"].values())
    row["program_breakdown"] = program_breakdown(rec)
    if "program" in rec:
        row["spans"] = len(rec["program"]["spans"])
    del out, rec
    gc.collect()
    import torch

    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return row


def main(argv=None, *, root: Path = ROOT, device: str = "cuda") -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    for i, p in enumerate((HERE, ROOT / "src")):
        if str(p) not in sys.path:
            sys.path.insert(i, str(p))
    import run as entry

    entry._caches()
    modes = args.modes.split(",")
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            row = run_one(args.workload, seed, args.seconds, mode, root=root,
                          device=device)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
