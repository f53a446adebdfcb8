"""Nothing a run imports is JAX or the JAX package (whole top-level
names), and the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from cmbench import harness

CMBENCH = os.path.join(ROOT, "benchmarks", "cmbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "circuitmap_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert "circuitmap_torch" not in harness.forbidden_modules()
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_benchmark_sources_import_no_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmarks")):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(dirpath, f)))
                assert not names & set(harness.FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "datagen.py", "counts.py", "check.py",
              "spans.py"):
        names = set(_imports(os.path.join(CMBENCH, f)))
        assert "circuitmap_torch" not in names, f
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "from cmbench import check, counts, datagen, reference, spans; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'circuitmap_torch'))").format(
        ROOT, os.path.join(ROOT, "benchmarks"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = ("import sys, time; sys.path[:0] = [{root!r}, {bench!r}]; "
            "sys.path.insert(0, {tests!r}); "
            "from conftest import tiny_spec; from cmbench import harness; "
            "spec = tiny_spec('map1000.demix_fit'); "
            "harness.run_cell(spec, 5, 0.1, 0, 'cpu', time.perf_counter(), "
            "log=lambda s: None); print(harness.forbidden_modules())").format(
        root=ROOT, bench=os.path.join(ROOT, "benchmarks"),
        tests=os.path.join(ROOT, "benchmarks", "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
