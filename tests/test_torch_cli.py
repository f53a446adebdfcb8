"""``python -m circuitmap_torch serve`` and ``fit`` on the CPU.

One subprocess server takes the CLI, SIGTERM and restart path: a stream
of two blocks, SIGTERM (exit 0, the stream saved under --state-dir), a
second server that loads it and takes a third block, which must equal
an uninterrupted in-process ``OnlineCaviar`` stream. ``fit`` runs in
process, and with ``--server`` against a loopback server.
"""

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from http.server import HTTPServer

import numpy as np
import pytest

from circuitmap_torch import __main__ as cli_main
from circuitmap_torch import serve as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMIXER = os.path.join(REPO, "demixers", "nwd_ie_ChroME2f.npz")
N, K = 20, 240


@pytest.fixture(scope="module")
def sim():
    import circuitmap_torch as cm

    np.random.seed(11)
    return cm.simulate(N=N, trials=K, H=3, connection_prob=0.2,
                       verbose=False, device="cpu")


def _start(state_dir):
    """A ``serve --device cpu --port 0`` subprocess; returns (proc, port,
    the SERVING line)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "circuitmap_torch", "serve", "--device",
         "cpu", "--port", "0", "--state-dir", str(state_dir)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    deadline = time.time() + 120
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if line.startswith("SERVING"):
            return proc, int(line.split("port=")[1].split()[0]), line
        if not line:
            break
    proc.kill()
    raise RuntimeError(f"no SERVING line: {proc.stderr.read()[-2000:]}")


def test_serve_sigterm_saves_the_stream_and_a_restart_continues_it(
        sim, tmp_path):
    from circuitmap_torch import OnlineCaviar

    create = {"powers": [45.0, 55.0, 65.0], "analytic_mc": True}
    blocks = [slice(80 * i, 80 * (i + 1)) for i in range(3)]
    proc, port, line = _start(tmp_path)
    try:
        assert line.split()[1:4] == ["host=127.0.0.1", f"port={port}",
                                     "device=cpu"]
        cli = ts.FitClient(f"http://127.0.0.1:{port}")
        assert cli.health()["platform"] == "cpu"
        for i, sl in enumerate(blocks[:2]):
            cli.stream_update("rig A/1", sim["psc"][sl],
                              sim["stim_matrix"][:, sl], iters=3,
                              create=create if i == 0 else None)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0
        assert "SIGTERM: stopping gracefully" in out
        assert "stream 'rig A/1' ->" in out
    finally:
        if proc.poll() is None:
            proc.kill()
    assert os.path.exists(tmp_path / "rig%20A%2F1.npz")

    proc, port, _ = _start(tmp_path)
    try:
        cli = ts.FitClient(f"http://127.0.0.1:{port}")
        loaded = cli.stream_load("rig A/1", create=create)
        assert loaded == {"loaded": "rig A/1", "trial_count": 160,
                          "iterations": 6, "designer": False}
        cli.stream_update("rig A/1", sim["psc"][blocks[2]],
                          sim["stim_matrix"][:, blocks[2]], iters=3)
        got = cli.stream_result("rig A/1")
        assert cli.shutdown() == {"shutting_down": True}
        proc.communicate(timeout=60)
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()

    local = OnlineCaviar(N, device="cpu", **create)
    for sl in blocks:
        local.update(sim["psc"][sl], sim["stim_matrix"][:, sl], iters=3)
    want = local.result()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=1e-6, atol=0, err_msg=key)


def _experiment(sim, tmp_path):
    data = tmp_path / "expt.npz"
    np.savez(data, psc=sim["psc"], stimulus_matrix=sim["stim_matrix"])
    config = tmp_path / "config.yaml"
    config.write_text(f"demixer: {DEMIXER}\nmsrmp: 0.3\n"
                      "powers: [45, 55, 65]\ntransfer_dtype: f32\n")
    return data, config


def test_fit_in_process_exports_the_chain_s_weights(sim, tmp_path, capsys):
    from circuitmap_torch import Model
    from circuitmap_torch.demix.demixer import NeuralDemixer

    data, config = _experiment(sim, tmp_path)
    assert cli_main.main(["fit", "--data", str(data), "--config",
                          str(config), "--out", str(tmp_path / "out"),
                          "--iters", "4", "--device", "cpu"]) == 0
    assert "Wrote:" in capsys.readouterr().out
    got = np.load(tmp_path / "out" / "expt_cmap.npz")
    dem = NeuralDemixer(DEMIXER, device="cpu")(
        sim["psc"], keep_on_device=True, transfer_dtype="f32",
        verbose=False)
    model = Model(N).fit(dem, sim["stim_matrix"], device="cpu",
                         fit_options={"msrmp": 0.3, "iters": 4,
                                      "powers": [45.0, 55.0, 65.0],
                                      "save_histories": False,
                                      "verbose": False})
    assert np.array_equal(got["weights"], model.state["mu"])
    assert np.array_equal(got["spikes"], model.state["lam"])
    assert os.path.exists(tmp_path / "out" / "expt_cmap.mat")


def test_fit_with_server_runs_on_the_server(sim, tmp_path, capsys):
    data, config = _experiment(sim, tmp_path)
    svc = ts.FitService(demixer_path=DEMIXER, device="cpu")
    box = [None]
    httpd = HTTPServer(("127.0.0.1", 0), ts._make_handler(svc, box))
    box[0] = httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert cli_main.main(["fit", "--data", str(data), "--config",
                              str(config), "--out", str(tmp_path / "srv"),
                              "--iters", "4", "--server", url]) == 0
        local = ts.FitClient(url).fit(
            sim["psc"].astype(np.float32),
            sim["stim_matrix"].astype(np.float32), demix=True,
            trace_wire="f32", msrmp=0.3, iters=4, save_histories=False,
            powers=[45.0, 55.0, 65.0])
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert f"on {url}" in capsys.readouterr().out
    assert svc.n_fits == 2 and svc.n_demixes == 2
    got = np.load(tmp_path / "srv" / "expt_cmap.npz")
    assert np.array_equal(got["weights"], local["mu"])


def test_help_unknown_command_and_mesh(capsys):
    assert cli_main.main([]) == 0
    listing = capsys.readouterr().out
    assert "serve" in listing and "fit" in listing
    assert cli_main.main(["nope"]) == 2
    meshed = json.loads(ts.FitService(mesh_devices=2,
                                      device="cpu").do_health()[1])
    assert meshed["mesh_devices"] == 2  # what `serve --mesh 2` builds
    with pytest.raises(SystemExit):
        cli_main.main(["serve", "--warm", "1000-20000"])
    health = json.loads(ts.FitService(device="cpu").do_health()[1])
    assert health["platform"] == "cpu" and health["mesh_devices"] == 0
