"""The simulation-study commands of ``python -m circuitmap_torch`` against
the JAX package's scripts (``scripts_tpu/``), on the CPU at N=20, and
the port's ``utils/metrics.py`` against the JAX package's.

Both simulators draw from the global ``np.random`` stream in the same
order, so one seed gives the same experiment: the ground truth and the
design are held exactly, the synthesised traces at float32 rounding.
``signal-fidelity``: the observed traces exactly, the ground-truth and
demixed traces within 1e-5 and 1e-4 of their peak (float32 on either
side). Each command's fit equals the port's own fit on the same
arguments (1e-6 relative), and the two packages' connection sets agree
with precision and recall >= 0.9 on these easy maps. ``design-study``:
each arm's numbers against the JAX record and against the library's
replay of the protocol (tolerances in the test).
"""

import bz2
import json
import pickle

import numpy as np
import pytest

from cli_parity import (one_host_thread,  # noqa: F401 (autouse)
                        DEMIXER, POWERS, assert_connections_agree,
                        assert_fit_equal, run_jax, run_port, sides, summary)
from circuitmap_torch.utils import metrics
from circuitmap_tpu.utils import metrics as jmetrics

N, K = 20, 240


@pytest.mark.parametrize("case", ["overlap", "disjoint", "empty", "flat"])
def test_connection_metrics_equal_jax(case):
    rng = np.random.default_rng(3)
    a = rng.normal(size=30) * (rng.random(30) < 0.4)
    b = {"overlap": a * (rng.random(30) < 0.7) + (rng.random(30) < 0.1),
         "disjoint": (a == 0) * 1.0, "empty": np.zeros(30),
         "flat": np.ones(30)}[case]
    assert metrics.precision_recall_connections(a, b) == \
        jmetrics.precision_recall_connections(a, b)
    assert metrics.precision_recall_connections(b, a) == \
        jmetrics.precision_recall_connections(b, a)
    assert metrics.correlation(a, b) == jmetrics.correlation(a, b)
    assert metrics.correlation(a.reshape(5, 6), b) == jmetrics.correlation(
        a.reshape(5, 6), b)
    assert metrics.r2_score(a, b) == jmetrics.r2_score(a, b)


def test_simulations_match_jax(tmp_path, monkeypatch, capsys):
    from circuitmap_torch import Model, simulate

    jd, pd = sides(tmp_path)
    argv = ["--N", N, "--trials", K, "--H", 3, "--connection_prob", 0.2,
            "--iters", 20, "--token", "t"]
    jout = run_jax("run_simulations", argv, monkeypatch, jd, capsys)
    pout = run_port("simulations", argv, monkeypatch, pd, capsys)
    prefixes = ("caviar:", "cavi_sns:", "cosamp:", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 4
    name = f"simulation_results_t_N{N}_K{K}.pkl.bz2"
    with bz2.BZ2File(jd / name) as fh:
        want = pickle.load(fh)
    with bz2.BZ2File(pd / name) as fh:
        got = pickle.load(fh)
    assert sorted(got) == sorted(want)
    for key in want["sim"]:
        np.testing.assert_array_equal(got["sim"][key], want["sim"][key])
    for method in ("caviar", "cavi_sns", "cosamp"):
        assert sorted(got[method]) == sorted(want[method])
    for method in ("caviar", "cavi_sns"):
        assert set(got[method]["state"]) >= {"mu", "beta", "lam", "shape",
                                             "rate", "phi", "phi_cov"}
    assert_connections_agree(got["caviar"]["state"]["mu"],
                             np.asarray(want["caviar"]["state"]["mu"]))
    # the same traces up to float32 rounding give the same greedy picks
    np.testing.assert_allclose(got["cosamp"]["weights"],
                               want["cosamp"]["weights"], rtol=1e-4,
                               atol=1e-6)
    # the command's fits are the library's on the same simulation
    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=3, connection_prob=0.2, spont_prob=0.05,
                   verbose=False, device="cpu")
    for method, opts in (("caviar", {"msrmp": 0.3}), ("cavi_sns", {})):
        model = Model(N).fit(sim["psc"], sim["stim_matrix"], method=method,
                             device="cpu",
                             fit_options=dict(opts, iters=20, verbose=False))
        for field in ("mu", "lam", "phi"):
            assert_fit_equal(got[method]["state"][field], model.state[field])


@pytest.fixture(scope="module")
def expt(tmp_path_factory):
    from circuitmap_torch.simulation import simulate

    np.random.seed(11)
    sim = simulate(N=N, trials=K, H=3, connection_prob=0.2, verbose=False,
                   device="cpu")
    path = tmp_path_factory.mktemp("expt") / "expt.npz"
    np.savez(path, psc=sim["psc"], stimulus_matrix=sim["stim_matrix"])
    return str(path)


def test_downsampling_matches_jax(expt, tmp_path, monkeypatch, capsys):
    from circuitmap_torch import Model
    from circuitmap_torch.utils.io import load_experiment

    jd, pd = sides(tmp_path)
    argv = ["--data", expt, "--fractions", 0.5, 1.0, "--repeats", 2,
            "--iters", 20, "--out", "ds.npz"]
    jout = run_jax("run_downsampling", argv, monkeypatch, jd, capsys)
    pout = run_port("downsampling", argv, monkeypatch, pd, capsys)
    prefixes = ("frac=", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 5
    want, got = (dict(np.load(d / "ds.npz")) for d in (jd, pd))
    assert sorted(got) == sorted(want) == ["fractions", "times", "weights"]
    for key in want:
        assert got[key].shape == want[key].shape and \
            got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got["fractions"], want["fractions"])
    for r in range(2):
        assert_connections_agree(got["weights"][1, r], want["weights"][1, r])
    # each subset's fit is the library's fit on the same trials
    psc, stim = load_experiment(expt)
    rng = np.random.default_rng(0)
    for i, frac in enumerate((0.5, 1.0)):
        for r in range(2):
            sel = np.sort(rng.choice(K, int(frac * K), replace=False))
            model = Model(N).fit(psc[sel], stim[:, sel], device="cpu",
                                 fit_options={"iters": 20, "msrmp": 0.3,
                                              "verbose": False})
            assert_fit_equal(got["weights"][i, r], model.state["mu"])


def test_signal_fidelity_matches_jax(tmp_path, monkeypatch, capsys):
    jd, pd = sides(tmp_path)
    argv = ["--demixer", DEMIXER, "--N", N, "--expt_len_s", 2,
            "--stim_freqs", 10, 30, "--out", "sf.npz"]
    jout = run_jax("run_signal_fidelity", argv, monkeypatch, jd, capsys)
    pout = run_port("signal-fidelity", argv, monkeypatch, pd, capsys)
    prefixes = ("stim_freq=", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 3
    want, got = (dict(np.load(d / "sf.npz")) for d in (jd, pd))
    assert sorted(got) == sorted(want) == sorted(
        f"{k}_{f}" for k in ("true", "obs", "demixed") for f in (10, 30))
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
        tol = {"obs": 0.0, "true": 1e-5, "demixed": 1e-4}[key.split("_")[0]]
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=tol * np.abs(want[key]).max(),
                                   err_msg=key)


DS_ARGS = dict(N=N, H=3, block=80, rounds=3, connection_prob=0.25)
DS_ARMS = ("adaptive_final", "static_at_matched_budget", "static_full_budget")


def _replay_design_study(N, H, block, rounds, connection_prob, device):
    """Seed 0 of the design study rebuilt from the library (``simulate``,
    ``blockwise_design``, ``OnlineCaviar``, ``AdaptiveDesigner``, the
    metrics), drawing from ``np.random`` in the command's order: the
    circuit, the designs, the static arm, then the adaptive arm. Returns
    each arm's per-round records."""
    from circuitmap_torch import OnlineCaviar, simulate
    from circuitmap_torch.design import AdaptiveDesigner
    from circuitmap_torch.simulation import blockwise_design
    from circuitmap_torch.utils.metrics import (precision_recall_connections,
                                                r2_score)

    np.random.seed(100)
    truth = simulate(N=N, trials=8, H=H, powers=POWERS,
                     connection_prob=connection_prob, verbose=False,
                     device=device)
    designs = [blockwise_design(N, H, block, POWERS) for _ in range(rounds)]
    arms = {}
    for adaptive in (False, True):
        oc = OnlineCaviar(N, powers=POWERS, device=device)
        designer = AdaptiveDesigner(N, H, POWERS, null_trials=18,
                                    conn_trials=30)
        history = []
        for r, stim in enumerate(designs):
            if adaptive and r > 0:
                stim = designer.next_design(stim.shape[1])
            psc = simulate(N=N, stim_matrix=stim, weights=truth["weights"],
                           phi_0=truth["phi_0"], phi_1=truth["phi_1"],
                           kernel=(truth["tau_r"], truth["tau_d"]),
                           powers=POWERS, verbose=False,
                           device=device)["psc"]
            oc.update(psc, stim, iters=8)
            post = oc.posterior()
            designer.observe(stim, post)
            prec, rec = precision_recall_connections(truth["weights"],
                                                     post["mu"])
            history.append({"trials": int(oc.trial_count),
                            "r2": float(r2_score(truth["weights"],
                                                 post["mu"])),
                            "precision": float(prec), "recall": float(rec),
                            "unresolved": int(designer.pool.size)})
            if adaptive and designer.resolved:
                break
        arms["adaptive" if adaptive else "static"] = history
    return arms


def test_design_study_matches_jax(tmp_path, monkeypatch, capsys):
    """Both arms of an easy map (5 connections among 20 cells): the
    deterministic fields equal the JAX script's; each arm's precision
    and recall at 0.9 or more in both packages, and its R2 within 0.01
    of the JAX one (float32 on either side; the two packages' streams
    part by ~3e-3 in R2 over these rounds); and every number of each
    arm equal to the library's replay of the protocol (1e-6 relative
    for R2, exactly for the rest)."""
    jd, pd = sides(tmp_path)
    argv = [a for k, v in DS_ARGS.items() for a in (f"--{k}", v)]
    argv += ["--seeds", 1, "--out", "ds.json"]
    jout = run_jax("design_study", argv, monkeypatch, jd, capsys)
    pout = run_port("design-study", argv, monkeypatch, pd, capsys)
    prefixes = ("seed ", "wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 2
    want = json.loads((jd / "ds.json").read_text())
    got = json.loads((pd / "ds.json").read_text())
    assert sorted(got) == sorted(want)
    assert got["protocol"] == want["protocol"]
    g, w = got["per_seed"][0], want["per_seed"][0]
    assert sorted(g) == sorted(w)
    # deterministic: the circuit (same seed) and each arm's budget
    for key in ("seed", "n_true_connections", "static_rounds",
                "adaptive_rounds"):
        assert g[key] == w[key]
    assert w["n_true_connections"] == 5
    for arm in DS_ARMS:
        assert sorted(g[arm]) == sorted(w[arm])
        assert (g[arm]["trials"], g[arm]["unresolved"]) == \
            (w[arm]["trials"], w[arm]["unresolved"])
        for side in (g, w):
            assert side[arm]["precision"] >= 0.9, (arm, side[arm])
            assert side[arm]["recall"] >= 0.9, (arm, side[arm])
        assert abs(g[arm]["r2"] - w[arm]["r2"]) <= 0.01, arm
    # both arms are the library's protocol on the same draws
    arms = _replay_design_study(**DS_ARGS, device="cpu")
    assert g["static_rounds"] == len(arms["static"])
    assert g["adaptive_rounds"] == len(arms["adaptive"])
    stop = arms["adaptive"][-1]["trials"]
    matched = max((h for h in arms["static"] if h["trials"] <= stop),
                  key=lambda h: h["trials"])
    for arm, replay in (("adaptive_final", arms["adaptive"][-1]),
                        ("static_full_budget", arms["static"][-1]),
                        ("static_at_matched_budget", matched)):
        for key, val in replay.items():
            if key == "r2":
                assert_fit_equal(g[arm][key], val)
            else:
                assert g[arm][key] == val, (arm, key)
