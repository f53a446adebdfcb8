"""The two studies the port adds beside the JAX package's
``scripts_tpu/``, on the CPU: ``circuitmap_torch.scripts.sweep_frontier_study``
(on a grid cut to a few seconds; ``--quick`` and the full grid are the
JAX script's, less its "xla8" arm, which the record lists as not run)
and ``circuitmap_torch.scripts.over_cliff_sharded --quick`` (on 8 CPU
shards it is given; the JAX script's data generator bit for bit).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from circuitmap_torch.scripts import over_cliff_sharded as oc
from circuitmap_torch.scripts import sweep_frontier_study as sf

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs: the suite
    runs in parallel workers, and a pool of threads per worker
    oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts_tpu" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_frontier_grid_is_the_jax_grid_without_xla8():
    shapes, seeds, blocks, iters = sf.grid(False)
    assert shapes == [(1000, 20000), (2000, 20000)] and iters == 50
    assert len(seeds) >= 3
    assert blocks == [1, 8, 10, 12, 16, "perm8"]
    assert sf.grid(True) == ([(100, 2000)], [0, 1], [1, 8, "perm8"], 20)
    assert set(sf.NOT_RUN) == {"xla8"}


def test_frontier_study_writes_its_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sf, "grid", lambda quick: (
        [(40, 600)], [0], [1, 8, "perm8"], 5))
    out = tmp_path / "frontier.json"
    assert sf.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["iters"] == 5
    assert rec["not_run"] == sf.NOT_RUN
    assert [r["block"] for r in rec["results"]] == ["1", "8", "perm8"]
    for row in rec["results"]:
        assert {"N", "K", "seed", "r2", "fit_warm_s", "fit_cold_s",
                "launches"} <= set(row)
        assert np.isfinite(row["r2"])
        # a CPU fit launches no kernel
        assert row["launches"] == {"B1": 0, "B3": 0, "B2": 0}
    table = capsys.readouterr().out
    assert "| 40 | 600 | perm8 |" in table
    assert not (tmp_path / "SWEEP_FRONTIER.json").exists()


def test_perm8_undoes_its_relabelling():
    """A perm8 fit returns the weights in the original neuron order: it
    recovers the map as the block-8 fit does (the two visit the neurons
    in other orders, so they agree to the fit's noise, not bit for
    bit)."""
    import circuitmap_torch as cm
    from circuitmap_torch.model import default_priors
    from circuitmap_torch.utils.metrics import r2_score

    np.random.seed(3)
    sim = cm.simulate(N=30, trials=300, H=3, connection_prob=0.2,
                      verbose=False, device="cpu")
    pri = default_priors(30)
    base = sf.fit_block(sim["psc"], sim["stim_matrix"], pri, 8, 4, 10,
                        "cpu")
    mu = sf.fit_block(sim["psc"], sim["stim_matrix"], pri, "perm8", 4, 10,
                      "cpu")
    assert r2_score(sim["weights"], mu) > 0.9  # measured 0.9508
    assert np.corrcoef(mu, base)[0, 1] > 0.999  # measured 0.999999


def test_over_cliff_data_equals_the_jax_script():
    jax_oc = _jax_script("over_cliff_sharded")
    for args in ((60, 500), (40, 300, 4, 3, 0.2)):
        for a, b in zip(oc.synth_charge_experiment(*args),
                        jax_oc.synth_charge_experiment(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_over_cliff_quick_on_eight_cpu_shards(tmp_path, capsys):
    out = tmp_path / "cliff.json"
    assert oc.main(["--quick", "--devices", *["cpu"] * 8, "--out",
                    str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["mesh_devices"] == ["cpu"] * 8
    assert rec["backend"].startswith("cpu (8 shards")
    assert rec["host"]["cpus"] >= 1
    assert rec["cliff_elements_tpu_v5e"] == 6.8e8
    assert rec["cliff_elements_h100"] == 32000 * 106250
    assert "H100" in rec["cliff_h100_device"]
    assert [(r["N"], r["K"]) for r in rec["results"]] == [(100, 2000),
                                                          (50, 1500)]
    for row in rec["results"]:
        assert not row["over_tpu_cliff"] and not row["over_h100_cliff"]
        assert row["r2"] > 0.9
    assert capsys.readouterr().out.count('"N"') == 2


def test_over_cliff_defaults_to_the_cards(tmp_path, monkeypatch):
    """Without --devices the mesh is every visible card, and with none
    the script raises rather than run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "c.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oc.main(["--quick", "--out", str(out)])
    assert not out.exists()


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu", "cpu:0"]],
                         ids=["shared", "distinct"])
def test_over_cliff_takes_a_device_list(tmp_path, devices, monkeypatch):
    import circuitmap_torch.scripts.over_cliff_sharded as mod

    seen = []
    real = mod.run_leg
    monkeypatch.setattr(mod, "run_leg", lambda N, K, iters, mesh, cliff: (
        seen.append(mesh), real(N, K, iters, mesh, cliff))[1])
    out = tmp_path / "c.json"
    assert mod.main(["--quick", "--devices", *devices, "--out",
                     str(out)]) == 0
    assert [str(d) for d in seen[0].devices] == devices
    assert json.loads(out.read_text())["mesh_devices"] == devices
