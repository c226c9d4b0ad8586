"""Nothing the benchmark runs imports the JAX stack, the JAX package
(``repro``) or the old scripts under ``benchmarks/``, compared by
whole top-level module names; the reference imports nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    for f in PERFBENCH.rglob("*.py"):
        if "tests" in f.relative_to(PERFBENCH).parts:
            continue
        assert not _top_level_imports(f) & FORBIDDEN, f


def test_reference_imports_no_program():
    for f in (PERFBENCH / "reference").rglob("*.py"):
        names = _top_level_imports(f)
        assert names <= {"__future__", "math", "torch"}, (f, names)


def test_loaded_modules_after_a_run(smoke_root):
    """A whole CPU run in a fresh process, then ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{str(PERFBENCH)!r}, {str(PERFBENCH.parent / 'src')!r}]
import io, contextlib, run
from pathlib import Path
with contextlib.redirect_stdout(io.StringIO()):
    rc = run.main(["--workload", "bertl-cam.rag", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], device="cpu",
                  root=Path({str(smoke_root)!r}))
assert rc == 0, rc
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
