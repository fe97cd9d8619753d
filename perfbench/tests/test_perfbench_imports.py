"""No module the benchmark loads is JAX or the JAX package; the reference
loads nothing of the program.  Top-level module names are compared whole:
``navier_stokes_tpu_torch`` is the program, ``navier_stokes_tpu`` is not
allowed."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.harness import FORBIDDEN_MODULES

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
PROGRAM = "navier_stokes_tpu_torch"


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_nothing_forbidden():
    for path in ROOT.rglob("*.py"):
        assert not _imported_tops(path) & set(FORBIDDEN_MODULES), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        assert PROGRAM not in _imported_tops(path), path


def test_loaded_modules_hold_no_jax():
    """Import everything a run imports (the harness, every configuration
    with the program modules it builds from, every reader, the reference,
    the trace reduction) in a fresh process and read ``sys.modules``."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from perfbench import harness, trace, peaks, control
import perfbench.reference.systems
import navier_stokes_tpu_torch.flagship, navier_stokes_tpu_torch.models
import navier_stokes_tpu_torch.mesh.generators
import navier_stokes_tpu_torch.ops.block_mv
root = Path(harness.__file__).parent
for p in sorted((root / "configs").glob("*.py")):
    harness.load_module(p, "c_" + p.stem.replace("-", "_").replace(".", "_"))
for p in sorted((root / "metrics").glob("*.py")):
    if p.stem != "__init__":
        harness.load_module(p, "m_" + p.stem.replace(".", "_"))
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & set(harness.FORBIDDEN_MODULES)))
print(harness.forbidden_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "navier_stokes_tpu_torch_like", sys)
    assert "navier_stokes_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "navier_stokes_tpu.sub", sys)
    assert "navier_stokes_tpu" in harness.forbidden_loaded()
