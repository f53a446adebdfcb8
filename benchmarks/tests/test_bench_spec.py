"""Discovery by name: every cell's configuration, mix and limits, and
every per-layer metric's reader; the file's entries keep to the names
and limits of the benchmark's contract."""

import json
import os
import re

import pytest
from conftest import ROOT

from cmbench import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = harness.Spec(ROOT, cell)
    assert spec.config["name"] == spec.cell["config"]
    K = harness.kind(spec.traffic)
    for name in ("make_data", "Driver", "end_to_end", "reference",
                 "numbers", "control"):
        assert callable(getattr(K, name)), name
    assert spec.limits and all(v > 0 for v in spec.limits.values())
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


def test_entries_keep_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


def test_a_new_kind_is_found_by_name(tmp_path, monkeypatch):
    # a kind of request is a file of its own: adding one edits nothing
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "echo.py").write_text(
        "BIG = ()\n"
        "def end_to_end(traffic, window_s, answered, latencies):\n"
        "    return {'echo_s': window_s / max(answered, 1)}\n")
    monkeypatch.setattr(harness, "BENCH_DIR", str(tmp_path))
    K = harness.kind({"request": "echo"})
    assert K.end_to_end({}, 2.0, 4, []) == {"echo_s": 0.5}


def test_end_to_end_values_are_read_by_name():
    spec = harness.Spec(ROOT, "map1000.fit")
    out = harness._end_to_end(spec, {"map_s": 0.3, "other": 1.0}, 12.0)
    assert out == {"setup_s": {"value": 12.0, "unit": "s"},
                   "map_s": {"value": 0.3, "unit": "s"}}
    with pytest.raises(RuntimeError):
        harness._end_to_end(spec, {"served_map_s": 0.3}, 12.0)


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.Spec(ROOT, "no.such.cell")
