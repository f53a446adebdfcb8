"""The demixer commands of ``python -m circuitmap_torch`` against the JAX
package's scripts (``scripts_tpu/``), on the CPU.

``train-demixer`` and ``train-qat-demixer`` draw their training pairs
from the same ``np.random`` sequence in both packages: the pairs are
held exactly, the first epoch's loss at 1e-4 relative and the trained
weights at 1e-4 of the state's largest entry (float32 convolutions and
autograd sum in another order: ``tests/test_torch_training.py``).
``denoise-grids``: the demixed traces within 1e-4 of their peak
(float32), each plane's map equal to the port's ``Model.fit`` on the
same arguments (1e-6 relative) and the connection sets of the two
packages' maps within precision and recall >= 0.9. ``export-ckpt``:
the written tensors bit for bit.
"""

import numpy as np
import pytest
import torch

from cli_parity import (one_host_thread,  # noqa: F401 (autouse)
                        DEMIXER, POWERS, assert_connections_agree,
                        assert_fit_equal, run_jax, run_port, sides, summary)
from circuitmap_torch.demix import convert
from circuitmap_torch.demix.demixer import NeuralDemixer
from circuitmap_tpu.demix.demixer import NeuralDemixer as JaxDemixer

STATE_RTOL = 1e-4


def _record(monkeypatch, cls, name, into):
    """Wrap ``cls.name`` so each call's result is appended to ``into``."""
    original = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        into.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapper)


def _state_rel(got_path, want_path):
    """max |port - JAX| over every floating entry of two saved
    checkpoints over the largest entry of the JAX one."""
    got, want = convert.load_params(got_path), convert.load_params(want_path)
    keys = [k for k in want if want[k].is_floating_point()]
    err = max(float((got[k].double() - want[k].double()).abs().max())
              for k in keys)
    return err / max(float(want[k].double().abs().max()) for k in keys)


def _train_pair(script, command, argv, tmp_path, monkeypatch, capsys):
    """Both packages' training command on the same argv (np.random seeded
    alike); returns (JAX, port) recorded (pairs, history) and printed
    output, the sides' directories."""
    jd, pd = sides(tmp_path)
    runs = []
    for cls, run, where in ((JaxDemixer, run_jax, jd),
                            (NeuralDemixer, run_port, pd)):
        pairs, hist = [], []
        with monkeypatch.context() as m:
            _record(m, cls, "generate_training_data", pairs)
            _record(m, cls, "train", hist)
            np.random.seed(0)  # sample_gp's global stream
            out = run(script if run is run_jax else command, argv,
                      monkeypatch, where, capsys)
        runs.append((pairs, hist, out))
    return runs, jd, pd


def _same_pairs(jax_run, port_run):
    (jtr, jte), (ttr, tte) = jax_run[0][0], port_run[0][0]
    for a, b in zip((*jtr, *jte), (*ttr, *tte)):
        np.testing.assert_array_equal(b, a)


def test_train_demixer_matches_jax(tmp_path, monkeypatch, capsys):
    # from the same weights: a fresh network is drawn from each package's
    # own random stream (the port follows the JAX rule, not its draws)
    argv = ["--size", 256, "--epochs", 1, "--out", "dm.npz", "--seed", 2,
            "--pretrained", DEMIXER]
    (jrun, trun), jd, pd = _train_pair("train_demixer", "train-demixer",
                                       argv, tmp_path, monkeypatch, capsys)
    _same_pairs(jrun, trun)
    jh, th = jrun[1][0], trun[1][0]
    assert len(th) == len(jh) == 1
    np.testing.assert_allclose(th[0]["train_loss"], jh[0]["train_loss"],
                               rtol=1e-4)
    prefixes = ("epoch ", "Training complete", "Saved demixer")
    assert summary(trun[2], prefixes) == summary(jrun[2], prefixes)
    assert len(summary(trun[2], prefixes)) == 3
    assert _state_rel(pd / "dm.npz", jd / "dm.npz") < STATE_RTOL
    # the command's weights are the library's training on the same pairs
    np.random.seed(0)
    from circuitmap_torch.scripts.train_demixer import training_data_kwargs

    dm = NeuralDemixer(DEMIXER, seed=2, device="cpu")
    dm.generate_training_data(**training_data_kwargs("chrome2f_ie", 256, 2))
    dm.train(epochs=1, learning_rate=1e-2, verbose=False)
    saved = convert.load_params(pd / "dm.npz")
    for key, val in dm.net.state_dict().items():
        if val.is_floating_point():
            torch.testing.assert_close(saved[key], val, rtol=0, atol=0)


def test_train_qat_demixer_matches_jax(tmp_path, monkeypatch, capsys):
    import json

    argv = ["--size", 256, "--epochs", 1, "--decimate", 2, "--pretrained",
            DEMIXER, "--out", "qat.npz"]
    jd, pd = sides(tmp_path)
    # the JAX script takes --cpu; the port's --device cpu
    runs = []
    for cls, run, where, extra in ((JaxDemixer, run_jax, jd, ["--cpu"]),
                                   (NeuralDemixer, run_port, pd, [])):
        pairs, hist = [], []
        with monkeypatch.context() as m:
            _record(m, cls, "generate_training_data", pairs)
            _record(m, cls, "train", hist)
            np.random.seed(0)
            name = "train_qat_demixer" if run is run_jax else \
                "train-qat-demixer"
            out = run(name, argv + extra, monkeypatch, where, capsys)
        runs.append((pairs, hist, out))
    jrun, trun = runs
    _same_pairs(jrun, trun)
    np.testing.assert_allclose(trun[1][0][0]["train_loss"],
                               jrun[1][0][0]["train_loss"], rtol=1e-4)
    want = json.loads((jd / "qat.npz.meta.json").read_text())
    got = json.loads((pd / "qat.npz.meta.json").read_text())
    assert sorted(got) == sorted(want)
    for key in ("pretrained", "bits", "decimate", "epochs", "size",
                "learning_rate", "preset"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["final_train_loss"],
                               want["final_train_loss"], rtol=1e-4)
    assert got["device"] == "cpu"
    assert json.loads(trun[2].strip().splitlines()[-1]) == got
    assert _state_rel(pd / "qat.npz", jd / "qat.npz") < STATE_RTOL
    # --cpu is --device cpu
    np.random.seed(0)
    out = run_port("train-qat-demixer", argv[:-1] + ["qat_cpu.npz", "--cpu"],
                   monkeypatch, pd, capsys, device=None)
    again = json.loads(out.strip().splitlines()[-1])
    assert again["device"] == "cpu"
    assert again["final_train_loss"] == got["final_train_loss"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A single-spot grid experiment: 2 planes of 4 x 5 locations, each
    location at each power 4 times (480 trials)."""
    from circuitmap_torch.simulation import simulate

    xs, ys = np.meshgrid(np.arange(4) * 10.0, np.arange(5) * 10.0,
                         indexing="ij")
    locs = np.array([(x, y, z) for z in (0.0, 30.0)
                     for x, y in zip(xs.ravel(), ys.ravel())])
    n = len(locs)
    rng = np.random.default_rng(4)
    target = np.tile(np.arange(n), 12)
    power = np.repeat(POWERS, 4 * n)
    order = rng.permutation(target.size)
    target, power = target[order], power[order]
    stim = np.zeros((n, target.size))
    stim[target, np.arange(target.size)] = power
    np.random.seed(9)
    sim = simulate(N=n, trials=target.size, H=1, connection_prob=0.3,
                   stim_matrix=stim, verbose=False, device="cpu")
    path = tmp_path_factory.mktemp("grid") / "grid.npz"
    np.savez(path, psc=sim["psc"], I=power, L=locs[target])
    return str(path)


def test_denoise_grids_matches_jax(grid, tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    from circuitmap_torch import Model
    from circuitmap_torch.scripts.denoise_grids import (
        make_plane_stim_matrices, weight_map_image)

    jd, pd = sides(tmp_path)
    argv = ["--data", grid, "--demixer", DEMIXER, "--iters", 10, "--out",
            "out"]
    dems = []
    with monkeypatch.context() as m:
        for cls in (JaxDemixer, NeuralDemixer):
            _record(m, cls, "__call__", dems)
        jout = run_jax("denoise_grids", argv, monkeypatch, jd, capsys)
        pout = run_port("denoise-grids", argv + ["--plot"], monkeypatch, pd,
                        capsys)
    jdem, tdem = (np.asarray(d) for d in dems)
    np.testing.assert_allclose(tdem, jdem, rtol=0,
                               atol=1e-4 * np.abs(jdem).max())
    prefixes = ("plane z=", "Wrote")
    assert summary(pout, prefixes) == summary(jout, prefixes)
    assert len(summary(pout, prefixes)) == 3
    want, got = (np.load(d / "out/weight_maps.npz") for d in (jd, pd))
    assert sorted(got.files) == sorted(want.files) == ["plane_0", "plane_30"]
    for key in want.files:
        assert got[key].shape == want[key].shape == (4, 5)
        assert_connections_agree(got[key].ravel(), want[key].ravel())
    assert {p.name for p in (pd / "out").glob("*.png")} == {
        "map_z0.png", "map_z30.png"}
    data = np.load(grid)
    for z, stim, trials, plane_locs in make_plane_stim_matrices(data["I"],
                                                                data["L"]):
        model = Model(stim.shape[0]).fit(
            tdem[trials], stim, device="cpu",
            fit_options={"iters": 10, "msrmp": 0.2, "save_histories": False,
                         "verbose": False})
        assert_fit_equal(got[f"plane_{z:g}"],
                         weight_map_image(plane_locs, model.state["mu"]))


def test_export_ckpt_matches_jax_bit_for_bit(tmp_path, monkeypatch, capsys):
    jd, pd = sides(tmp_path)
    argv = [DEMIXER, "out.ckpt", "--epoch", 7, "--global-step", 70]
    jout = run_jax("export_lightning", argv, monkeypatch, jd, capsys)
    pout = run_port("export-ckpt", argv, monkeypatch, pd, capsys,
                    device=None)  # host-only: it takes no --device
    assert pout == jout == ("wrote out.ckpt (54 tensors + BN counters, "
                            "reference NWDUNet layout)\n")
    want = torch.load(jd / "out.ckpt", weights_only=False)
    got = torch.load(pd / "out.ckpt", weights_only=False)
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "state_dict":
            assert got[key] == want[key], key
    assert list(got["state_dict"]) == list(want["state_dict"])
    for key, val in want["state_dict"].items():
        assert got["state_dict"][key].dtype == val.dtype, key
        assert torch.equal(got["state_dict"][key], val), key
    # the export reloads bit for bit as the checkpoint it came from
    back, src = convert.load_params(pd / "out.ckpt"), convert.load_params(
        DEMIXER)
    for key, val in src.items():
        assert torch.equal(back[key], val), key
