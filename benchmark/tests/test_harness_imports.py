"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program; a run without a card fails.

Top-level module names are compared whole: ``skred_tpu_torch`` begins
with ``skred_tpu`` and is allowed, ``skred_tpu`` is not.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "skred_tpu"}


def _imports(path: pathlib.Path) -> set:
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert "skred_tpu_torch" not in _imports(path)


def test_loaded_modules_in_a_process():
    """Import every benchmark module (and the program, as a run does) in
    a fresh process: no forbidden top-level name is loaded."""
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from benchmark import harness, trace, roofline
from benchmark.traffic import sweep, preview, variants
from benchmark.reference import synth, compare, control
from benchmark.reference.frozen import timeline
harness.import_program()
import skred_tpu_torch.engine.fused, skred_tpu_torch.frontends.repl
import skred_tpu_torch.host.native
for m in json.load(open({str(ROOT / 'BENCHMARK.json')!r}))["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_alone_loads_no_program():
    code = f"""
import sys, json
sys.path.insert(0, {str(ROOT)!r})
from benchmark.reference import synth, compare
compare.render([["v0 w1 f110 a1"]], 0.02)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split('.')[0] == 'skred_tpu_torch')))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result():
    """Without a visible card the run exits 2 and prints no result: it
    never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "stress64.sweep",
         "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 2
    assert "correct" not in out.stdout
    assert "cuda" in out.stderr.lower()
