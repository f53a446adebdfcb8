"""A tiny run of each mix on the CPU, through the harness's whole path
but the look for a card, to the last line's keys; the command itself
refuses a machine without the cell's cards and prints no result."""

import json
import os
import subprocess
import sys
import time

import pytest
from conftest import ROOT, tiny_spec

from cmbench import harness

CELLS = ["map1000.demix_fit", "map1000.fit", "map1000.served"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_gives_the_result_keys(cell, trace):
    spec = tiny_spec(cell)
    res = harness.run_cell(spec, 2**31 + 11, 0.2, trace, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert res["correct"], res["lines"]
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": 0}
    line = json.loads(json.dumps(harness.result_line(res, spec, device)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == set(spec.limits)
    if trace:
        assert "breakdown" in line
        names = {m["name"] for m in spec.per_layer}
        assert set(line["metrics"]) <= names
        # read from the untraced requests after the slice, on any machine
        on_host = {"map.mfu", "serve.handler_ms", "serve.response_mb"}
        assert names & on_host <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "run.py"),
         "--workload", "map1000.fit", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
