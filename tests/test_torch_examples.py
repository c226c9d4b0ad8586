"""The port's examples (``examples/torch_*.py``, the ports of the
reference's four) run on the CPU when asked, at their smallest
arguments, and print what the reference's print; without ``--device
cpu`` they need the card and raise without one."""

import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {
    "torch_quickstart": (["--batch", "1", "--seq", "64"],
                         ["dense vs binary cosine", "dense vs camformer "
                          "(6-bit ADC, sigma 1.4%) cosine", "recall@32",
                          "two-stage recall@32", "191 qry/ms"]),
    "torch_serve_decode": (["--max-new", "2"],
                           ["[dense          ] 6 requests",
                            "[camformer      ] 6 requests",
                            "[dense,camformer", "[streaming      ]",
                            "[prefix sharing ]"]),
    "torch_train_lm": (["--tiny", "--steps", "2", "--seq", "32",
                        "--batch", "2"],
                       ["model: lm-tiny", "loss:"]),
    "torch_had_distill": (["--teacher-steps", "2", "--student-steps", "2",
                           "--seq", "32", "--batch", "2"],
                          ["dense teacher", "HAD student + two-stage",
                           "of the binarization gap"]),
}


def _run(name, argv):
    old = sys.argv
    sys.argv = [str(ROOT / "examples" / f"{name}.py"), *argv]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    argv, expect = EXAMPLES[name]
    if name == "torch_train_lm":
        argv = argv + ["--ckpt-dir", str(tmp_path / "ck")]
    _run(name, argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for text in expect:
        assert text in out, (text, out[-2000:])
    assert "nan" not in out.lower()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_the_card_unless_asked(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = EXAMPLES[name][0] + ["--ckpt-dir", str(tmp_path)] \
        if name == "torch_train_lm" else EXAMPLES[name][0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(name, argv)
