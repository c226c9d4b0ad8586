"""A configuration, a traffic mix and a per-layer metric added as files
of their own, with entries in BENCHMARK.json, are found by name: no file
of the harness changes."""

import json

import run


def test_new_files_are_found(smoke_root, capsys):
    pb = smoke_root / "perfbench"
    conf = json.loads((pb / "configs" / "bertl-cam.json").read_text())
    conf["name"] = "tiny-cam"
    conf["model"]["n_layers"] = 1
    (pb / "configs" / "tiny-cam.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "rag.json").read_text())
    mix.update(name="burst", clients=2)
    (pb / "traffic" / "burst.json").write_text(json.dumps(mix))
    (pb / "metrics" / "sched.ticks_seen.py").write_text(
        "def read(rec):\n    return float(rec['counters']['ticks'])\n")
    (pb / "limits" / "tiny-cam.burst.json").write_text(
        (pb / "limits" / "nemo12b-cam.rag.json").read_text())
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-cam", "source": "test",
                             "file": "perfbench/configs/tiny-cam.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-cam.burst",
                               "config": "tiny-cam", "traffic": "burst",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "sched.ticks_seen", "unit": "ticks",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "output_tokens_per_s",
                               "workloads": ["tiny-cam.burst"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "tiny-cam.burst", "--seed", "3",
                   "--seconds", "1", "--trace", "1"], device="cpu",
                  root=smoke_root)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert res["metrics"]["sched.ticks_seen"]["value"] > 0
    assert res["metrics"]["sched.ticks_seen"]["unit"] == "ticks"
