"""CPU tests of the benchmark harness; card-only tests carry the ``gpu``
marker and skip inside the test without a card.

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""

import shutil
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (str(ROOT / "src"), str(PERFBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test without one")


SMOKE_MODEL = dict(n_layers=2, d_model=64, n_heads=4, head_dim=32, d_ff=96,
                   vocab=256, k_top=8, group_size=4, dtype="float32")
SMOKE_TRAFFIC = dict(clients=3, max_len=64, check_tokens=400,
                     prompt_len={"dist": "log_uniform", "min": 4, "max": 24},
                     output_len={"dist": "log_uniform", "min": 4, "max": 24})
SMOKE_LIMITS = {"embed_err": {"limit": 0.0},
                "attn_err_prefill": {"limit": 1e-5},
                "attn_err_decode": {"limit": 1e-5},
                "rest_err_prefill": {"limit": 1e-5},
                "rest_err_decode": {"limit": 1e-5},
                "head_err_max": {"limit": 1e-5},
                "argmax_miss": {"limit": 0}}
# cells whose files the benchmark keeps for a later PR; the tests run
# them as cells: the chat mix, and the paper's geometry (G = 1, d = 64)
EXTRA_CELLS = (("nemo12b-cam.chat", "nemo12b-cam", "chat"),
               ("bertl-cam.rag", "bertl-cam", "rag"))


@pytest.fixture
def smoke_root(tmp_path):
    """A checkout's benchmark files with every configuration, mix and
    limit cut to a smoke size the CPU runs in seconds (float32, so the
    program and the reference agree to rounding)."""
    import json

    root = tmp_path / "checkout"
    root.mkdir()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bertl-cam", "source": "test",
                             "file": "perfbench/configs/bertl-cam.json",
                             "reduced": [], "why": "test"})
    for name, conf, mix in EXTRA_CELLS:
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": mix, "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "nemo12b-cam.rag" in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(PERFBENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (root / "perfbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        kv = 4 if c["model"]["n_kv_heads"] == c["model"]["n_heads"] else 1
        c["model"].update(SMOKE_MODEL, n_kv_heads=kv)
        c["engine"]["page_size"] = 16
        f.write_text(json.dumps(c))
    for f in (root / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(SMOKE_TRAFFIC)
        f.write_text(json.dumps(t))
    for w in bench["workloads"]:
        (root / "perfbench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(SMOKE_LIMITS))
    return root
