"""circuitmap_torch stands on its own.

The port and ``chip_smoke.py`` import neither JAX nor circuitmap_tpu nor
the JAX package's scripts (an AST scan, and subprocesses that run a CPU
fit, or import every command module, and then inspect ``sys.modules``); every entry point runs on the GPU unless asked for the
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
FORBIDDEN = ("jax", "jaxlib", "circuitmap_tpu", "scripts_tpu")
PORT_FILES = sorted((REPO / "circuitmap_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
# the modules of the streaming, resumable and closed-loop slice, of
# the training, continuous-simulation and analysis slice, of the
# serving slice and of the multi-device slice, which must be among the
# files scanned
SLICE_MODULES = ("utils/checkpoint.py", "solvers/resumable.py",
                 "solvers/online.py", "design.py", "summary.py",
                 "pipelines.py", "viz.py", "simulation.py",
                 "demix/unet.py", "demix/datagen.py", "demix/demixer.py",
                 "demix/convert.py", "demix/stacked.py",
                 "demix/template_fit.py", "serve.py", "__main__.py",
                 "utils/io.py", "utils/synthetic.py", "utils/quant.py",
                 "parallel/mesh.py", "parallel/sharded.py",
                 "parallel/distributed.py", "parallel/sweep.py",
                 "utils/profiling.py", "ops/_counts.py")


# the workflow commands, one module per script of scripts_tpu/
SCRIPT_MODULES = ("run_loho_cv", "generate_fanout_jobs", "run_1v10_pipeline",
                  "run_pair_patch_pipeline", "run_continuous_experiment",
                  "run_distributed_fit", "train_demixer", "train_qat_demixer",
                  "denoise_grids", "export_lightning", "run_simulations",
                  "run_downsampling", "run_signal_fidelity", "design_study",
                  "doctor", "hw_smoke", "warm_cache", "probe_memory_cliff",
                  "run_scaling_study", "wire_fidelity_study",
                  "measure_many_compile", "profile_fit_entry",
                  "profile_demixer", "profile_online")


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


@pytest.mark.parametrize("module", SCRIPT_MODULES)
def test_command_modules_are_scanned_and_stand_alone(module):
    """Each command module is among the scanned files, has the JAX
    script's file name and a ``main``, and imports nothing of JAX, the
    JAX package or its scripts (its relative imports stay in the
    port)."""
    path = REPO / "circuitmap_torch" / "scripts" / f"{module}.py"
    assert path in PORT_FILES
    assert (REPO / "scripts_tpu" / f"{module}.py").exists()
    assert not _imported_roots(path) & set(FORBIDDEN)
    tree = ast.parse(path.read_text())
    assert "main" in {n.name for n in tree.body
                      if isinstance(n, ast.FunctionDef)}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level <= 2, (module, node.module)


def test_command_modules_load_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SCRIPT_MODULES!r}:\n"
            "    importlib.import_module('circuitmap_torch.scripts.' + m)\n"
            "import circuitmap_torch.__main__\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


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


def test_the_mesh_refuses_to_fall_back_to_the_cpu(no_cuda):
    """A mesh without ``devices=`` is over the GPUs, and a process group
    without ``device=`` is a CUDA rank's: both raise without one."""
    from circuitmap_torch import parallel

    for call in (parallel.trial_mesh, lambda: parallel.trial_mesh(2),
                 lambda: parallel.initialize_distributed(
                     "tcp://localhost:1", world_size=1, rank=0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_the_fit_server_refuses_to_fall_back_to_the_cpu(no_cuda):
    from circuitmap_torch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.FitService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run_server(port=0)
    assert serve.FitService(device="cpu").platform == "cpu"


def test_lazy_exports():
    import circuitmap_torch as cm

    assert set(cm.__all__) == {
        "Model", "default_priors", "NeuralDemixer", "caviar", "caviar_many",
        "simulate", "cavi_sns", "mbcs", "cosamp", "mbcs_ard", "sns_many",
        "mbcs_many", "caviar_resumable", "OnlineCaviar", "pool_design",
        "AdaptiveDesigner", "closed_loop_map",
        "simulate_continuous_experiment", "summarize", "format_summary",
        "FitClient"}
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
    from circuitmap_torch import serve

    assert cm.FitClient is serve.FitClient
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


# The JAX package's public names the port does not have, each by design
# (ROADMAP A4), by JAX module; None: the whole module. Every entry must
# be missing from the port, so the list cannot outlive its reason.
# (``_ensure_compile_cache`` is private there: the port's counterpart is
# ops/_build.py's hash-keyed build, which ``warm-cache`` fills.)
ABSENT_BY_DESIGN = {
    # orbax is JAX's checkpointer; the port's .npz checkpoint holds the
    # same state
    "utils/checkpoint.py": {"save_state_orbax", "load_state_orbax"},
    # the functional JAX U-Net; the port's is an nn.Module on cuDNN
    "demix/unet.py": {"BN_BLOCK_ORDER", "avg_pool1d", "batch_norm",
                      "conv1d", "conv1d_fft", "conv1d_toeplitz",
                      "conv_transpose1d", "nwd_unet_forward",
                      "resize_linear", "update_running_stats"},
    "demix/__init__.py": {"nwd_unet_forward"},
    # jax.jit of laplace_phi_update; the port runs eagerly
    "solvers/_laplace.py": {"laplace_phi_update_jit"},
    # the native host encoder, queued (ROADMAP A4); numpy codes here
    "native/__init__.py": None,
    "utils/native.py": None,
    # the Pallas kernels; their CUDA counterparts are ops/sweep_cuda.py,
    # ops/sweep_row_cuda.py and ops/laplace_cuda.py
    "ops/sweep_pallas.py": None,
    "ops/laplace_pallas.py": None,
}
JAX_MODULES = sorted(p.relative_to(REPO / "circuitmap_tpu").as_posix()
                     for p in (REPO / "circuitmap_tpu").rglob("*.py"))


def _public_names(path):
    """A module's public names: top-level functions, classes and
    assignments, a literal ``__all__``, the keys of a ``_LAZY`` export
    table, and a package's imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "_LAZY":
                        names |= set(ast.literal_eval(node.value))
                    elif (target.id == "__all__"
                          and isinstance(node.value, ast.List)):
                        names |= set(ast.literal_eval(node.value))
        elif (isinstance(node, ast.ImportFrom)
              and path.name == "__init__.py"):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_module_has_the_jax_modules_public_names(module):
    """Each JAX module's public names are the port module's (as
    attributes, re-exports included), but for ABSENT_BY_DESIGN."""
    import importlib

    absent = ABSENT_BY_DESIGN.get(module, set())
    port = REPO / "circuitmap_torch" / module
    if absent is None:
        assert not port.exists()
        return
    dotted = "circuitmap_torch." + module[:-3].replace("/", ".")
    dotted = dotted.removesuffix(".__init__")
    mod = importlib.import_module(dotted)
    names = _public_names(REPO / "circuitmap_tpu" / module)
    missing = {n for n in names if not hasattr(mod, n)}
    assert missing == absent
