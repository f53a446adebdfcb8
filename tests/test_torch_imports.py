"""circuitmap_torch stands on its own.

The port and ``chip_smoke.py`` import neither JAX nor circuitmap_tpu (an
AST scan, and a subprocess that runs a CPU fit and then inspects
``sys.modules``); every entry point runs on the GPU unless asked for the
CPU, and raises rather than falling back when there is no GPU.
"""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "circuitmap_tpu")
PORT_FILES = sorted((REPO / "circuitmap_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
# the modules of the streaming, resumable and closed-loop slice and of
# the training, continuous-simulation and analysis slice, which must be
# among the files scanned
SLICE_MODULES = ("utils/checkpoint.py", "solvers/resumable.py",
                 "solvers/online.py", "design.py", "summary.py",
                 "pipelines.py", "viz.py", "simulation.py",
                 "demix/unet.py", "demix/datagen.py", "demix/demixer.py",
                 "demix/convert.py", "demix/stacked.py",
                 "demix/template_fit.py")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_files_import_neither_jax_nor_the_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_scanned(module):
    path = REPO / "circuitmap_torch" / module
    assert path in PORT_FILES
    assert "torch" in _imported_roots(path) or "numpy" in _imported_roots(
        path)


_CPU_RUN = r"""
import sys
import numpy as np
import circuitmap_torch as cm
from circuitmap_torch.utils.metrics import r2_score

np.random.seed(7)
sim = cm.simulate(N=30, trials=300, H=3, connection_prob=0.2, verbose=False,
                  device="cpu")
dem = cm.NeuralDemixer("demixers/nwd_ie_ChroME2f_int4d2qat.npz",
                       device="cpu")(sim["psc"], keep_on_device=True,
                                     transfer_dtype="int4d2", verbose=False)
model = cm.Model(30).fit(dem, sim["stim_matrix"], device="cpu",
                         fit_options={"iters": 10, "verbose": False})
assert np.isfinite(model.state["mu"]).all()
print("r2", r2_score(sim["weights"], model.state["mu"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "circuitmap_tpu"))
print("loaded", bad)
"""


def test_cpu_pipeline_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CPU_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "loaded []"
    assert float(lines[-2].split()[1]) > 0.5


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_cuda):
    import circuitmap_torch as cm

    stim = np.zeros((4, 8))
    stim[0, ::2] = 45.0
    psc = np.zeros((8, 50))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.simulate(N=4, trials=8, H=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.NeuralDemixer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.Model(4).fit(psc, stim, fit_options={"verbose": False})
    p = cm.default_priors(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.caviar(psc, stim, p["mu"], p["beta"], p["shape"], p["rate"],
                  p["phi"], p["phi_cov"], verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.caviar_many(np.stack([psc, psc]), np.stack([stim, stim]),
                       p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
                       p["phi_cov"], verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.cavi_sns(psc, stim, p["mu"], p["beta"], p["alpha"], p["shape"],
                    p["rate"], p["phi"], p["phi_cov"], verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.mbcs(psc, stim, p["mu"], p["beta"], p["shape"], p["rate"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.mbcs_ard(psc, stim, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.caviar_resumable(psc, stim, p["mu"], p["beta"], p["shape"],
                            p["rate"], p["phi"], p["phi_cov"], "ck",
                            verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.OnlineCaviar(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.sns_many(np.stack([psc, psc]), np.stack([stim, stim]),
                    p["mu"], p["beta"], p["alpha"], p["shape"], p["rate"],
                    p["phi"], p["phi_cov"], verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.mbcs_many(np.stack([psc, psc]), np.stack([stim, stim]),
                     p["mu"], p["beta"], p["shape"], p["rate"],
                     verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.closed_loop_map(lambda s: psc, 4, 1, [45.0], 8, 1)
    for method in ("cavi_sns", "mbcs", "cosamp"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cm.Model(4).fit(psc, stim, method=method)
    from circuitmap_torch import pipelines, simulation
    from circuitmap_torch.demix.template_fit import fit_psc_templates

    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.simulate_continuous_experiment(N=4, H=1, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulation.simulate_continuous_experiment_without_spike_failures(N=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_psc_templates(psc[:2], steps=1, restarts=1)
    state = {"mu": np.ones(4), "lam": stim / 45.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelines.connection_waveforms(psc, stim, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelines.merge_duplicate_connections(psc, stim, state,
                                              np.zeros((4, 3)))


def test_lazy_exports():
    import circuitmap_torch as cm

    assert set(cm.__all__) == {
        "Model", "default_priors", "NeuralDemixer", "caviar", "caviar_many",
        "simulate", "cavi_sns", "mbcs", "cosamp", "mbcs_ard", "sns_many",
        "mbcs_many", "caviar_resumable", "OnlineCaviar", "pool_design",
        "AdaptiveDesigner", "closed_loop_map",
        "simulate_continuous_experiment", "summarize", "format_summary"}
    from circuitmap_torch import design, solvers
    from circuitmap_torch.solvers.experimental import mbcs_ard

    for name in ("caviar", "caviar_many", "cavi_sns", "mbcs", "cosamp",
                 "sns_many", "mbcs_many", "caviar_resumable",
                 "OnlineCaviar"):
        assert getattr(cm, name) is getattr(solvers, name)
    for name in ("pool_design", "AdaptiveDesigner", "closed_loop_map"):
        assert getattr(cm, name) is getattr(design, name)
    assert cm.mbcs_ard is mbcs_ard
    from circuitmap_torch import simulation, summary

    assert cm.simulate_continuous_experiment is \
        simulation.simulate_continuous_experiment
    assert cm.summarize is summary.summarize
    assert cm.format_summary is summary.format_summary
    with pytest.raises(AttributeError):
        cm.not_a_name  # noqa: B018


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_the_gpu(no_cuda, where, tmp_path):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
