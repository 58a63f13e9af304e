"""Nothing the benchmark runs loads JAX, flax or the JAX package, and the
plain reference loads nothing of the program either.  Module names are
compared by their whole top-level name: ``sdtk_tpu_torch`` is not
``sdtk_tpu``."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sdtk_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert "sdtk_tpu_torch" not in top_level_imports(path), path


def test_a_run_loads_none_of_them(tmp_path):
    """A small batch cell run in a fresh process, then its loaded modules."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(HERE)!r}, {str(ROOT)!r}]
import torch, run
from conftest import small_cell, SMALL
from pathlib import Path
cell = small_cell("ecapa-c512.batch-3s", **SMALL["batch"])
res = run.run_cell(cell, 7, 0.1, False, torch.device("cpu"), t_start=time.perf_counter(),
                   root=Path({str(tmp_path)!r}))
print(json.dumps({{"found": run.forbidden_modules(), "correct": res["correct"],
                   "torch_port": "sdtk_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "correct": True, "torch_port": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "sdtk_tpu_torch_extra", sys)
    assert "sdtk_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sdtk_tpu.store", sys)
    assert "sdtk_tpu" in run.forbidden_modules()
