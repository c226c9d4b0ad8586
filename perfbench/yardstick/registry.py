"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, metrics and
configurations; each configuration, traffic mix, metric and cell limit
is a file of its own under ``perfbench/``:

    perfbench/configs/<config>.json   sizes, engine flags, source
    perfbench/traffic/<traffic>.json  loop, clients, lengths, sampling
    perfbench/metrics/<metric>.py     ``read(record) -> float | None``
    perfbench/limits/<workload>.json  the limits that decide ``correct``

A later cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                     f"{[w['name'] for w in bench['workloads']]}")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"unknown config {name!r}")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file a ``configs`` entry names."""
    return load_json(root / config_entry(bench, name)["file"])


def traffic(name: str, base: Path = PERFBENCH) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(workload_name: str, base: Path = PERFBENCH) -> dict:
    return load_json(base / "limits" / f"{workload_name}.json")


def metrics_for(bench: dict, workload_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: the end-to-end
    metrics untraced, the per-layer ones traced; an entry with a
    ``workloads`` key only in the cells it lists."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload_name in m["workloads"]]


def metric_reader(name: str, base: Path = PERFBENCH):
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
