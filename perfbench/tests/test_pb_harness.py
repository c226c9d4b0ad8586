"""The harness end to end on the CPU at smoke size: each cell's run
prints a well-formed last line, traced and untraced."""

import json

import pytest

import run

CELLS = ("nemo12b-cam.chat", "nemo12b-cam.rag", "bertl-cam.rag")


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_result(smoke_root, capsys, cell, trace):
    rc = run.main(["--workload", cell, "--seed", str(2**31 + 11),
                   "--seconds", "1.5", "--trace", str(trace)],
                  device="cpu", root=smoke_root)
    assert rc == 0
    res = last_line(capsys)
    assert list(res)[-1] == "check"
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    group = bench["per_layer" if trace else "end_to_end"]
    want = {m["name"] for m in group
            if cell in m.get("workloads", [cell])}
    # device-trace metrics have nothing to read on the CPU
    cpu_silent = {m["name"] for m in group if m["source"] == "device_trace"}
    assert want - cpu_silent <= set(res["metrics"]) <= want
    for name, m in res["metrics"].items():
        assert isinstance(m["value"], float) and m["value"] >= 0, name
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(capsys):
    """On a machine without a card the command prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "nemo12b-cam.rag", "--seed", "1",
                   "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""


def test_same_seed_same_traffic(smoke_root):
    """The seed fixes the requests; another seed gives the same lengths
    round by round, in another order."""
    from yardstick import loadgen, registry

    t = registry.traffic("chat", smoke_root / "perfbench")
    a, b = (loadgen.Plan(t, s, 256) for s in (2**31 + 5, 2**31 + 5))
    c = loadgen.Plan(t, 7, 256)
    for r in range(3):
        assert [a.request(k, r) for k in range(3)] == \
            [b.request(k, r) for k in range(3)]
    assert [c.request(k, 0)[0] for k in range(3)] != \
        [a.request(k, 0)[0] for k in range(3)]
