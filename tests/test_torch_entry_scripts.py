"""The port's entry scripts on the CPU: the NeuroCAAS shell entry point
``circuitmap_torch/scripts/run_circuitmap_main.sh`` (its fit's files, as
``python -m circuitmap_torch fit`` writes them, zipped).
"""

import os
import shutil
import subprocess
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from circuitmap_torch import __main__ as cli_main

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "circuitmap_torch" / "scripts" / "run_circuitmap_main.sh"
DEMIXER = REPO / "demixers" / "nwd_ie_ChroME2f.npz"


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


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    import circuitmap_torch as cm

    tmp = tmp_path_factory.mktemp("expt")
    np.random.seed(5)
    sim = cm.simulate(N=20, trials=200, H=3, connection_prob=0.2,
                      verbose=False, device="cpu")
    data = tmp / "expt.npz"
    np.savez(data, psc=sim["psc"], stimulus_matrix=sim["stim_matrix"])
    config = tmp / "config.yaml"
    config.write_text(f"demixer: {DEMIXER}\nmsrmp: 0.3\n"
                      "powers: [45, 55, 65]\ntransfer_dtype: f32\n")
    return data, config


def _run(args, env_extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(["bash", str(SCRIPT), *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def zip_tool():
    if shutil.which("zip") is None:
        pytest.skip("the shell entry point packs its results with zip")


def test_shell_entry_point_zips_the_fit_s_files(experiment, tmp_path, zip_tool):
    data, config = experiment
    proc = _run([str(data), str(config), str(tmp_path / "out"), "--device",
                 "cpu", "--iters", "3"])
    assert proc.returncode == 0, proc.stderr
    assert "---- LAUNCHING CIRCUITMAP (torch) ----" in proc.stdout
    archive = tmp_path / "out" / "expt_cm.zip"
    assert f"results: {archive}" in proc.stdout
    with zipfile.ZipFile(archive) as zf:
        assert sorted(zf.namelist()) == ["expt_cmap.mat", "expt_cmap.npz"]
        zf.extractall(tmp_path / "unzipped")
    # the same files as the fit command run in process
    assert cli_main.main(["fit", "--data", str(data), "--config",
                          str(config), "--out", str(tmp_path / "direct"),
                          "--device", "cpu", "--iters", "3"]) == 0
    got = np.load(tmp_path / "unzipped" / "expt_cmap.npz")
    want = np.load(tmp_path / "direct" / "expt_cmap.npz")
    for key in ("weights", "weight_uncertainty", "spikes"):
        assert np.array_equal(got[key], want[key]), key


def test_shell_entry_point_reads_the_environment(experiment, tmp_path):
    """DATA_PATH / CONFIG_PATH / RESULT_PATH stand in for arguments 1-3;
    with no fit flags the fit asks for the GPU (the package's device
    rule), which this machine does not have."""
    data, config = experiment
    out = tmp_path / "env-out"
    proc = _run([], {"DATA_PATH": str(data), "CONFIG_PATH": str(config),
                     "RESULT_PATH": str(out), "CUDA_VISIBLE_DEVICES": ""})
    assert "---- LAUNCHING CIRCUITMAP (torch) ----" in proc.stdout
    assert out.is_dir()
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()
    assert not (out / "expt_cm.zip").exists()


def test_shell_entry_point_needs_its_paths(tmp_path):
    proc = _run([])
    assert proc.returncode != 0
    assert "usage: run_circuitmap_main.sh DATA CONFIG OUT_DIR" in proc.stderr
