"""The control: the reference computed in float8 e4m3 (the step below
the configurations' bfloat16) put in the program's place fails the
committed limits.  On the CPU at a reduced width; on the card
(``gpu``) at nemo12b-cam's full width through a window of the rag
cell."""

import json
import time
from pathlib import Path

import pytest
import torch

from yardstick import cell, check, registry
from yardstick import weights as W

PERFBENCH = Path(__file__).resolve().parents[1]


def _fails(numbers, limits) -> list:
    return [n for n in check.COMPARED
            if numbers[n] > float(limits[n]["limit"])]


def test_control_fails_limits_cpu():
    from repro_torch.configs import get_config
    from repro_torch.models.module import param_shapes

    conf = registry.load_json(PERFBENCH / "configs" / "nemo12b-cam.json")
    model = dict(conf["model"], n_layers=2, d_model=256, n_heads=4,
                 n_kv_heads=1, head_dim=128, d_ff=512, vocab=512)
    cfg = get_config(conf["arch"]).replace(**model)
    params = W.draw(param_shapes(cfg), 7, torch.device("cpu"),
                    torch.bfloat16)
    g = torch.Generator().manual_seed(7)
    picked = [(i, torch.randint(0, 512, (64,), generator=g).tolist(),
               torch.randint(0, 512, (16,), generator=g).tolist())
              for i in range(2)]
    got = check.control_numbers(cell.model_numbers(cfg), params, picked)
    for w in registry.load_benchmark(PERFBENCH.parent)["workloads"]:
        limits = registry.limits(w["name"], PERFBENCH)
        assert _fails(got, limits), (w["name"], got)


@pytest.mark.gpu
def test_control_fails_limits_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = 4242
    out = cell.run("nemo12b-cam.rag", seed, 30.0, False,
                   t_proc0=time.perf_counter(), root=PERFBENCH.parent)
    picked = check.sample(out["finished"], seed, 256)
    got = check.control_numbers(out["cfg_numbers"], out["params"], picked)
    limits = registry.limits("nemo12b-cam.rag", PERFBENCH)
    assert _fails(got, limits), json.dumps(got)
