"""The 2,000-candidate map: its configuration is map1000's at twice the
candidates and twice the trials, and its cell runs the harness's whole
path (a tiny run on the CPU, the program against the reference on
seeded data) to the result line's keys."""

import json
import os
import time

import pytest
from conftest import ROOT, tiny_spec

from cmbench import harness

# the keys that describe a configuration rather than set it
DESCRIPTIVE = {"name", "source", "deployment", "assumed"}


def _config(name):
    with open(os.path.join(ROOT, "benchmarks", "configs",
                           name + ".json")) as fh:
        return json.load(fh)


def test_map2000_is_map1000_at_twice_the_candidates_and_trials():
    small, big = _config("map1000"), _config("map2000")
    assert set(small) == set(big)
    differ = {k for k in small if small[k] != big[k]}
    assert differ - DESCRIPTIVE == {"N", "trials"}
    assert (big["N"], big["trials"]) == (2000, 40000)
    # stimulations per neuron, H * K / N: 200 in both, twice SCALING.md's
    # ~100 floor
    per_neuron = [c["H"] * c["trials"] / c["N"] for c in (small, big)]
    assert per_neuron == [200.0, 200.0]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next(c for c in bench["configs"] if c["name"] == "map2000")
    assert entry["file"] == "benchmarks/configs/map2000.json"
    assert entry["reduced"] == [] and entry["source"] == big["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == "map2000.fit")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "map2000", "fit", 1)


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_map2000_fit_run_is_correct(trace):
    spec = tiny_spec("map2000.fit")
    res = harness.run_cell(spec, 2**31 + 2000, 0.2, trace, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert res["correct"], res["lines"]
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": 0}
    line = json.loads(json.dumps(harness.result_line(res, spec, device)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == set(spec.limits) == {"phi_med_gap",
                                                         "lam_med_gap"}
    if trace:
        assert "map.mfu" in line["metrics"]
        # a CPU run launches no B1: its plan and step time are not read
        assert not {"sweep.ring_depth", "sweep.step_us"} & set(
            line["metrics"])
    else:
        assert set(line["metrics"]) == {"setup_s", "map_s"}
