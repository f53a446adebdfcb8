"""The mapping workflows of ``python -m circuitmap_torch`` against the JAX
package's scripts (``scripts_tpu/``), on the CPU at N=20.

The same numpy-made experiment files go through the JAX script (in this
process, the suite's CPU JAX) and the port's command (``--device cpu``).
Held: the same output files, keys, shapes and dtypes and the same
printed summary lines up to numbers; deterministic outputs exactly (LOHO
fold ids and test-trial counts, the fan-out scripts' text with the
worker invocation swapped); each command's fit equal to the port's own
``Model.fit`` on the same arguments (1e-6 relative: the same code on the
same CPU); and the port's connection set against the JAX package's,
precision and recall each >= 0.9 on these easy maps (the packages draw
from different random streams). ``loho-cv``'s held-out prediction is
also applied to the JAX package's fit of each fold and must give the
JAX record's MSE (1e-6 relative). ``distributed-fit`` runs as two gloo
processes on the CPU against the in-process ``caviar_sharded``.
"""

import json
import os
import shlex
import socket
import subprocess
import sys

import numpy as np
import pytest

from cli_parity import (one_host_thread,  # noqa: F401 (autouse)
                        DEMIXER, POWERS, REPO, SCRIPTS, assert_connections_agree,
                        assert_fit_equal, assert_same_arrays, run_jax,
                        run_port, sides, summary)

N, K = 20, 240


@pytest.fixture(scope="module")
def expt(tmp_path_factory):
    """An .npz experiment whose holograms repeat (each twice)."""
    from circuitmap_torch.simulation import blockwise_design, simulate

    np.random.seed(11)
    stim = blockwise_design(N, 3, K, POWERS, nreps=2)
    sim = simulate(N=N, trials=K, H=3, connection_prob=0.2, stim_matrix=stim,
                   verbose=False, device="cpu")
    path = tmp_path_factory.mktemp("expt") / "expt.npz"
    np.savez(path, psc=sim["psc"], stimulus_matrix=sim["stim_matrix"])
    return str(path), sim


@pytest.fixture(scope="module")
def mat_expt(tmp_path_factory):
    """A .mat experiment of single-target and 5-target trials (200 of
    each), with target coordinates and a loose-patch recording of cell
    3 (a 1.0 step in its spiking trials)."""
    from scipy.io import savemat

    from circuitmap_torch.simulation import blockwise_design, simulate

    np.random.seed(5)
    stim = np.hstack([blockwise_design(N, 1, 200, POWERS),
                      blockwise_design(N, 5, 200, POWERS)])
    stim = stim[:, np.random.permutation(stim.shape[1])]
    sim = simulate(N=N, trials=stim.shape[1], H=5, connection_prob=0.25,
                   stim_matrix=stim, verbose=False, device="cpu")
    psp = 0.01 * np.random.default_rng(0).normal(size=sim["psc"].shape)
    psp[np.asarray(sim["spks"])[3] > 0, 150:200] += 1.0
    targets = np.column_stack([np.arange(N) % 5 * 20.0,
                               np.arange(N) // 5 * 20.0, np.zeros(N)])
    path = tmp_path_factory.mktemp("mat") / "expt.mat"
    savemat(path, {"pscs": sim["psc"], "stimulus_matrix": sim["stim_matrix"],
                   "psps": psp, "targets": targets})
    return str(path), sim


def _usage_groups(text):
    groups, title = {}, None
    for line in text.splitlines():
        if line.endswith(":") and not line.startswith(" "):
            title = line[:-1]
        elif line.startswith("  ") and title:
            groups[line.split()[0]] = title
    return groups


def test_listing_names_each_command_in_the_jax_groups(capsys):
    from circuitmap_torch import __main__ as cli
    from circuitmap_torch import __version__
    from circuitmap_tpu import __main__ as jcli

    ported = _usage_groups(cli.usage())
    jax_groups = _usage_groups(jcli._usage())
    # every command of the JAX package, the two that need the original
    # implementation listed as not ported
    assert set(ported) == set(jax_groups)
    assert len(ported) == 28
    for command, group in ported.items():
        assert jax_groups[command] == group, command
    assert cli.main([]) == 0
    assert cli.usage() in capsys.readouterr().out
    assert cli.main(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__


def test_dispatch_runs_from_another_directory(tmp_path):
    """``python -m circuitmap_torch`` in a subprocess started in another
    directory: the commands are the package's own modules, not files
    found next to it."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "circuitmap_torch", "export-ckpt", DEMIXER,
         "out.ckpt"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("wrote out.ckpt (54 tensors")


def _fold_opts(method):
    opts = {"iters": 50, "save_histories": False, "verbose": False}
    if method == "caviar":
        opts["msrmp"] = 0.3
    return opts


def _fold_fit(expt, fold, method="caviar"):
    """The port's in-process fit of one LOHO fold: (hologram, state)."""
    from circuitmap_torch import Model
    from circuitmap_torch.parallel.sweep import loho_folds
    from circuitmap_torch.utils.io import load_experiment

    psc, stim = load_experiment(expt[0])
    holo, train, _ = list(loho_folds(stim))[fold]
    model = Model(N).fit(psc[train], stim[:, train], method=method,
                         device="cpu", fit_options=_fold_opts(method))
    return holo, model.state


def _jax_fold(expt, fold, method="caviar"):
    """The JAX package's fit of one LOHO fold, as its script fits it:
    (hologram, state, held-out traces, held-out stim)."""
    from circuitmap_tpu import Model as JaxModel
    from circuitmap_tpu.parallel.sweep import loho_folds
    from circuitmap_tpu.utils.io import load_experiment

    psc, stim = load_experiment(expt[0])
    holo, train, test = list(loho_folds(stim))[fold]
    model = JaxModel(N)
    model.fit(psc[train], stim[:, train] * 1.0, method=method,
              fit_options=_fold_opts(method))
    state = {k: np.asarray(v) for k, v in model.state.items()}
    return holo, state, psc[test], stim[:, test]


def _connected_fold(expt):
    """The first LOHO fold whose held-out hologram targets a connected
    cell: there the held-out prediction depends on the fitted power
    curve (the first folds of the fixture hold out unconnected cells)."""
    from circuitmap_torch.parallel.sweep import loho_folds
    from circuitmap_torch.utils.io import load_experiment

    _, stim = load_experiment(expt[0])
    connected = np.asarray(expt[1]["weights"]) != 0
    return next(i for i, (_, _, test) in enumerate(loho_folds(stim))
                if (stim[connected][:, test] > 0).any())


def _hold_folds_against_jax(expt, got, want, method, folds):
    """Each fold of the port's records against the JAX script's: the
    port's held-out prediction (``held_out_mse``) applied to the JAX
    package's fit of the fold gives the JAX record's MSE (1e-6 relative:
    the same host numpy formula on the same float32 arrays), that fit
    has the JAX record's connection count, and the port's fit of the
    fold (equal to the command's record) agrees with it in connections
    (precision and recall >= 0.9)."""
    from circuitmap_torch.scripts.run_loho_cv import held_out_mse

    assert len(got) == len(want) == len(folds)
    for fold, g, w in zip(folds, got, want):
        holo, jstate, psc_test, stim_test = _jax_fold(expt, fold, method)
        assert holo == w["hologram"] == g["hologram"]
        np.testing.assert_allclose(
            held_out_mse(jstate, psc_test, stim_test), w["held_out_mse"],
            rtol=1e-6)
        assert int(np.count_nonzero(jstate["mu"])) == w["n_connections"]
        _, state = _fold_fit(expt, fold, method)
        np.testing.assert_allclose(
            g["held_out_mse"], held_out_mse(state, psc_test, stim_test),
            rtol=1e-6)
        assert g["n_connections"] == int(np.count_nonzero(state["mu"]))
        assert_connections_agree(state["mu"], jstate["mu"])


def test_loho_cv_matches_jax_and_its_fold_worker(expt, tmp_path, monkeypatch,
                                                 capsys):
    jd, pd = sides(tmp_path)
    argv = ["--data", expt[0], "--max_folds", 2, "--out", "cv.json"]
    jout = run_jax("run_loho_cv", argv, monkeypatch, jd, capsys)
    pout = run_port("loho-cv", argv, monkeypatch, pd, capsys)
    prefixes = ("fold ", "Wrote", "2 holograms")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 4
    want = json.loads((jd / "cv.json").read_text())
    got = json.loads((pd / "cv.json").read_text())
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):  # deterministic: fold ids, test trials
        assert (g["hologram"], g["test_trials"]) == (w["hologram"],
                                                     w["test_trials"])
    # each fold: the library's fit of it, and the JAX package's
    _hold_folds_against_jax(expt, got, want, "caviar", [0, 1])
    # the --fold worker writes <out>.fold_I.json, the sweep's record
    out = run_port("loho-cv", ["--data", expt[0], "--fold", 1, "--out",
                               "cv.json"], monkeypatch, pd, capsys)
    assert "1 holograms;" in out
    worker = json.loads((pd / "cv.json.fold_1.json").read_text())
    assert len(worker) == 1
    for key in ("hologram", "test_trials", "n_connections"):
        assert worker[0][key] == got[1][key]
    np.testing.assert_allclose(worker[0]["held_out_mse"],
                               got[1]["held_out_mse"], rtol=1e-6)
    # a worker on a fold that holds out a connected cell, against the
    # JAX script's worker on it
    fold = _connected_fold(expt)
    argv = ["--data", expt[0], "--fold", fold, "--out", "cv.json"]
    run_jax("run_loho_cv", argv, monkeypatch, jd, capsys)
    run_port("loho-cv", argv, monkeypatch, pd, capsys)
    name = f"cv.json.fold_{fold}.json"
    want, got = (json.loads((d / name).read_text()) for d in (jd, pd))
    _hold_folds_against_jax(expt, got, want, "caviar", [fold])
    with pytest.raises(SystemExit, match="out of range"):
        run_port("loho-cv", ["--data", expt[0], "--fold", 10_000],
                 monkeypatch, pd, capsys)


def test_loho_cv_mbcs_matches_jax(expt, tmp_path, monkeypatch, capsys):
    """``--method mbcs`` (its state keeps the prior power curve, which
    the held-out prediction goes through): the worker on a fold that
    holds out a connected cell, held as the CAVIaR folds are."""
    jd, pd = sides(tmp_path)
    fold = _connected_fold(expt)
    argv = ["--data", expt[0], "--fold", fold, "--method", "mbcs",
            "--out", "cv.json"]
    run_jax("run_loho_cv", argv, monkeypatch, jd, capsys)
    run_port("loho-cv", argv, monkeypatch, pd, capsys)
    name = f"cv.json.fold_{fold}.json"
    want, got = (json.loads((d / name).read_text()) for d in (jd, pd))
    _hold_folds_against_jax(expt, got, want, "mbcs", [fold])


@pytest.mark.parametrize("backend", ["slurm", "bash", "list"])
def test_fanout_scripts_match_jax_with_the_worker_swapped(
        expt, tmp_path, monkeypatch, capsys, backend):
    jd, pd = sides(tmp_path)
    argv = ["--data", expt[0], "--backend", backend, "--out-dir", "jobs",
            "--demixer", DEMIXER, "--max-array", 50, "--jobs", 3]
    jout = run_jax("generate_fanout_jobs", argv, monkeypatch, jd, capsys)
    pout = run_port("fanout-jobs", argv, monkeypatch, pd, capsys,
                    device=None)
    python = shlex.quote(sys.executable)
    swap = (f"{python} {shlex.quote(str(SCRIPTS / 'run_loho_cv.py'))}",
            f"{python} -m circuitmap_torch loho-cv")
    assert pout == jout.replace(*swap)
    files = sorted(p.relative_to(jd) for p in jd.rglob("*.sh"))
    assert files == sorted(p.relative_to(pd) for p in pd.rglob("*.sh"))
    assert len(files) == {"slurm": 3, "bash": 1, "list": 0}[backend]
    for f in files:
        assert (pd / f).read_text() == (jd / f).read_text().replace(*swap)
        assert os.access(pd / f, os.X_OK)
    if backend == "list":
        assert len(pout.splitlines()) == 120
    # --device goes on to the workers
    out = run_port("fanout-jobs", ["--data", expt[0], "--backend", "list"],
                   monkeypatch, pd, capsys)
    assert out.splitlines()[0].endswith(
        "--device cpu --fold 0 --out loho_cv.json")


def _pipeline_fit(psc_dem, stim, locs):
    from circuitmap_torch import Model

    return Model(N).fit(psc_dem[locs], stim[:, locs] * 1.0, device="cpu",
                        fit_options={"msrmp": 0.3, "save_histories": False,
                                     "verbose": False})


def _demixed(path):
    from scipy.io import loadmat

    from circuitmap_torch.demix.demixer import NeuralDemixer

    data = loadmat(path)
    return (NeuralDemixer(DEMIXER, device="cpu")(data["pscs"], verbose=False),
            data["stimulus_matrix"])


def test_pipeline_1v10_matches_jax(mat_expt, tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    from scipy.io import loadmat

    from circuitmap_torch.pipelines import split_single_ensemble

    jd, pd = sides(tmp_path)
    argv = ["--data", mat_expt[0], "--demixer", DEMIXER, "--out", "out",
            "--merge_duplicates"]
    jout = run_jax("run_1v10_pipeline", argv, monkeypatch, jd, capsys)
    pout = run_port("pipeline-1v10", argv, monkeypatch, pd, capsys)
    prefixes = ("trials:", "single:", "ensemble:", "single-vs-ensemble",
                "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 7  # 2 merge lines included
    stem = "out/expt_msrmp0.3"
    assert (pd / f"{stem}_checkerboard.png").stat().st_size > 0
    want, got = (loadmat(d / f"{stem}_models.mat") for d in (jd, pd))
    keys = [k for k in want if not k.startswith("__")]
    assert_same_arrays({k: got[k] for k in keys}, {k: want[k] for k in keys})
    for name in ("single", "ensemble"):
        assert_connections_agree(got[f"weights_{name}"],
                                 want[f"weights_{name}"])
    psc_dem, stim = _demixed(mat_expt[0])
    single, ensemble = split_single_ensemble(stim)
    for name, locs in (("single", single), ("ensemble", ensemble)):
        model = _pipeline_fit(psc_dem, stim, locs)
        assert_fit_equal(got[f"weights_{name}"][0], model.state["mu"])
        assert_fit_equal(got[f"spikes_{name}"], model.state["lam"])
    # the .npz export and the fits without the figure (run())
    from circuitmap_torch.scripts import run_1v10_pipeline as p1v10

    args = p1v10.parse_args(["--data", mat_expt[0], "--demixer", DEMIXER,
                             "--out", str(pd / "npz"), "--fmt", "npz",
                             "--device", "cpu"])
    fits, _, _ = p1v10.run(args)
    p1v10.export(args, fits)
    saved = np.load(pd / "npz" / "expt_msrmp0.3_models.npz")
    assert sorted(saved.files) == sorted(keys)
    np.testing.assert_array_equal(saved["weights_single"],
                                  got["weights_single"][0])


def test_pipeline_pair_patch_matches_jax(mat_expt, tmp_path, monkeypatch,
                                         capsys):
    from scipy.io import loadmat

    from circuitmap_torch.pipelines import split_single_ensemble

    jd, pd = sides(tmp_path)
    argv = ["--data", mat_expt[0], "--demixer", DEMIXER, "--out", "out"]
    jout = run_jax("run_pair_patch_pipeline", argv, monkeypatch, jd, capsys)
    pout = run_port("pipeline-pair-patch", argv, monkeypatch, pd, capsys)
    prefixes = ("patched cell", "single:", "ensemble:", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 4
    want, got = (loadmat(d / "out/expt_msrmp0.3_pairpatch.mat")
                 for d in (jd, pd))
    keys = [k for k in want if not k.startswith("__")]
    exact = {"lp_cell", "lp_spikes", "curve_single_power",
             "curve_ensemble_power", "curve_single_lp_rate",
             "curve_ensemble_lp_rate", "curve_single_lp_std",
             "curve_ensemble_lp_std"}
    assert_same_arrays({k: got[k] for k in keys}, {k: want[k] for k in keys},
                       exact=exact)
    assert int(got["lp_cell"][0, 0]) == 3
    psc_dem, stim = _demixed(mat_expt[0])
    for name, locs in zip(("single", "ensemble"),
                          split_single_ensemble(stim)):
        assert_connections_agree(got[f"weights_{name}"],
                                 want[f"weights_{name}"])
        model = _pipeline_fit(psc_dem, stim, locs)
        assert_fit_equal(got[f"spikes_{name}"], model.state["lam"])


def test_continuous_matches_jax(tmp_path, monkeypatch, capsys):
    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "N": N, "Hs": [3], "stim_freqs": [30], "expt_len": 10,
        "subsample_every": 10, "connection_prob": 0.2, "spont_rate": 0.1,
        "max_power_min_spike_rate": 0.3, "demixer": DEMIXER}))
    jd, pd = sides(tmp_path)
    argv = ["--config", cfg, "--iters", 20, "--token", "t"]
    jout = run_jax("run_continuous_experiment", argv, monkeypatch, jd, capsys)
    pout = run_port("continuous", argv, monkeypatch, pd, capsys)
    prefixes = ("freq=", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 7  # raw/demixed x 3 methods
    want = json.loads((jd / "continuous_expt_t.json").read_text())
    got = json.loads((pd / "continuous_expt_t.json").read_text())
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key in ("stim_freq", "H", "subsample_s", "K", "input", "method"):
            assert g[key] == w[key]
        if w["method"] == "cosamp" and w["input"] == "raw":
            # the same traces (float32 rounding), the same greedy picks
            np.testing.assert_allclose(g["mu"], w["mu"], rtol=1e-4,
                                       atol=1e-6)
        if w["method"] == "caviar":
            assert_connections_agree(g["mu"], w["mu"])
    # the command's CAVIaR fit is the library's on the same experiment
    from circuitmap_torch import Model
    from circuitmap_torch.simulation import simulate_continuous_experiment

    np.random.seed(1)
    e = simulate_continuous_experiment(
        N=N, expt_len=200000, stim_freq=30, H=3, connection_prob=0.2,
        spont_rate=0.1, max_power_min_spike_rate=0.3, powers=[45, 55, 65],
        verbose=False, device="cpu")
    model = Model(N).fit(e["obs_responses"], e["stim_matrix"], device="cpu",
                         fit_options={"iters": 20, "msrmp": 0.3,
                                      "powers": [45, 55, 65],
                                      "save_histories": False,
                                      "verbose": False})
    assert_fit_equal(got[0]["mu"], model.state["mu"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


DIST_SPLIT = 121
DIST_FIELDS = {
    "caviar": ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"),
    "sns": ("mu", "beta", "alpha", "lam", "shape", "rate", "phi", "phi_cov"),
    "mbcs": ("mu", "beta", "lam", "shape", "rate", "z"),
}


def _in_process(solver, psc, stim):
    """The port's in-process sharded fit over 4 CPU shards at the
    command's arguments."""
    from circuitmap_torch import default_priors
    from circuitmap_torch.parallel import (caviar_sharded, cavi_sns_sharded,
                                           mbcs_sharded, trial_mesh)

    p = default_priors(N)
    mesh = trial_mesh(devices=["cpu"] * 4)
    if solver == "sns":
        out = cavi_sns_sharded(
            psc, stim, p["mu"], p["beta"], p["alpha"], p["shape"], p["rate"],
            p["phi"], p["phi_cov"], mesh=mesh, iters=4, seed=0,
            analytic_mc=True, save_histories=False, verbose=False)
    elif solver == "mbcs":
        out = mbcs_sharded(psc, stim, p["mu"], p["beta"], p["shape"],
                           p["rate"], mesh=mesh, iters=4, seed=0,
                           analytic_noise=True, save_histories=False)
    else:
        out = caviar_sharded(
            psc, stim, p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
            p["phi_cov"], mesh=mesh, iters=4, analytic_mc=True, powers=POWERS,
            sweep_block_size=1, fn_scan=False, verbose=False)
    fields = DIST_FIELDS["caviar" if solver == "checkpoint" else solver]
    return {f: np.asarray(v) for f, v in zip(fields, out)}


@pytest.mark.parametrize("solver", ["caviar", "checkpoint", "sns", "mbcs"])
def test_distributed_fit_two_processes_match_the_in_process_mesh(
        expt, tmp_path, solver):
    """Two gloo CPU processes of the command, each on 2 CPU shards of its
    uneven half, against the port's in-process sharded fit over 4 CPU
    shards: the ranks' gathered outputs are identical, and the fit has
    no gate flip against the in-process one (float32; the layouts pad
    and sum in another grouping, so values are held at 1e-4)."""
    from circuitmap_torch.utils.io import load_experiment

    psc, stim = load_experiment(expt[0])
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    extra = {"checkpoint": ["--checkpoint", tmp_path / "ck.npz",
                            "--checkpoint-every", 2],
             "sns": ["--solver", "sns"], "mbcs": ["--solver", "mbcs"]}
    procs = []
    for rank, (a, b) in enumerate(((0, DIST_SPLIT), (DIST_SPLIT, K))):
        np.savez(tmp_path / f"shard{rank}.npz", psc=psc[a:b], stim=stim[:, a:b])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "circuitmap_torch", "distributed-fit",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(rank), "--cpu-devices", "2",
             "--data", str(tmp_path / f"shard{rank}.npz"),
             "--out", str(tmp_path / f"out{rank}.npz"), "--iters", "4",
             "--analytic-mc", "--powers", *map(str, POWERS),
             *map(str, extra.get(solver, []))],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    lines = [json.loads([ln for ln in log.splitlines()
                         if ln.startswith("{")][-1]) for log in logs]
    assert [sorted(ln) for ln in lines] == [sorted([
        "process", "processes", "devices", "K_local", "K_global",
        "nonzero_weights"])] * 2
    assert [ln["process"] for ln in lines] == [0, 1]
    assert all(ln["processes"] == 2 and ln["devices"] == 4
               and ln["K_global"] == K for ln in lines)
    assert [ln["K_local"] for ln in lines] == [DIST_SPLIT, K - DIST_SPLIT]
    ranks = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    want = _in_process(solver, psc, stim)
    got = ranks[0]
    assert sorted(got) == sorted(want)
    assert int(np.sum((got["mu"] != 0) != (want["mu"] != 0))) == 0
    assert lines[0]["nonzero_weights"] == int(np.count_nonzero(want["mu"]))
    for key in want:
        assert_fit_equal(got[key], want[key], rtol=1e-4)
    if solver == "checkpoint":
        from circuitmap_torch.utils.checkpoint import load_state

        assert int(load_state(tmp_path / "ck.npz")["completed_iters"]) == 4
