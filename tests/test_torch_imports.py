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


def test_lazy_exports():
    import circuitmap_torch as cm

    assert set(cm.__all__) == {"Model", "default_priors", "NeuralDemixer",
                               "caviar", "caviar_many", "simulate"}
    from circuitmap_torch.solvers import caviar_many

    assert cm.caviar_many is caviar_many
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
