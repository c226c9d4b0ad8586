"""The port stands alone: no module of ``src/repro_torch``, no example
of the port (``examples/torch_*.py``), neither ``chip_smoke.py`` nor the
multi-process test workers (``tests/torch_*_worker.py``) import JAX or
the reference package, nothing is built
when the port is imported, and the entry points run on the card unless
the caller asks for the CPU."""

import argparse
import ast
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import smoke_config

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"] + [
    ROOT / "tests" / f"torch_{name}_worker.py" for name in ("dist", "tp")]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


def test_importing_the_port_builds_nothing(monkeypatch):
    from repro_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
    assert calls == []


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import gateway, serve
    from repro_torch.models import from_jax_params, init_params
    from repro_torch.serving import ServeEngine

    cfg = smoke_config("camformer-bert")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    params_np = {
        "embed": {k: v.numpy() for k, v in params["embed"].items()},
        "blocks": {mod: {name: torch.stack(
            [blk[mod][name] for blk in params["blocks"]]).numpy()
            for name in leaves}
            for mod, leaves in params["blocks"][0].items()},
        "ln_f": {k: v.numpy() for k, v in params["ln_f"].items()},
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(params_np, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "camformer-bert", "--smoke", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gateway.main(["--arch", "camformer-bert", "--smoke", "--port", "0"])
    # asked for the CPU, each runs the plain path
    eng = serve.main(["--arch", "camformer-bert", "--smoke", "--requests",
                      "2", "--max-new", "3", "--device", "cpu",
                      "--no-stream"])
    assert [r.finish_reason for r in eng.done] == ["length"] * 2
    ap = argparse.ArgumentParser()
    gateway.add_engine_args(ap, max_batch=2, max_len=64)
    eng = gateway.build_engine(ap.parse_args(
        ["--arch", "camformer-bert", "--smoke", "--device", "cpu"]))
    assert eng.device.type == "cpu"
    assert from_jax_params(params_np, cfg, device="cpu")["blocks"][1][
        "attn"]["wq"].equal(params["blocks"][1]["attn"]["wq"])
