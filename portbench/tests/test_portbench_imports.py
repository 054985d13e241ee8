"""Nothing under portbench/ imports JAX or the JAX package ``repro``, by
top-level name compared whole; the plain reference imports nothing of the
program; a whole run loads none of them."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK_ALLOWED = {"__future__", "numpy", "math", "statistics", "re",
                     "typing", "time", "collections", "dataclasses",
                     "portbench"}


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module.split(".")[0]
            else:
                yield "portbench"


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_repro(path):
    assert not set(imported_roots(path)) & FORBIDDEN


def test_top_level_names_are_compared_whole():
    from portbench import bench
    assert "repro_torch" not in bench.FORBIDDEN
    assert set(bench.FORBIDDEN) == FORBIDDEN


@pytest.mark.parametrize("name", ["reference", "roaring_bytes", "judge",
                                  "control", "peaks", "gen"])
def test_yardstick_imports_nothing_of_the_program(name):
    roots = set(imported_roots(BENCH / "yardstick" / f"{name}.py"))
    assert "repro_torch" not in roots
    if name in ("reference", "roaring_bytes", "judge", "control", "peaks"):
        assert roots <= YARDSTICK_ALLOWED, roots


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import bench\n"
        "line, _ = bench.run_workload(%r, 't-count', 5, 0.3, False, "
        "device='cpu', log=lambda _: None)\n"
        "print(json.dumps([line['correct'], bench.forbidden_modules()]))\n"
        % (str(BENCH.parent), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]
