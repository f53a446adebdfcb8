"""The Measurement commands of ``python -m circuitmap_torch`` and their
helpers (``utils/profiling.py``, the memory-envelope preflight), on the
CPU at cut sizes, against the JAX package.

The studies run at cut sizes with the JAX scripts' record keys. Where a
record holds a truth-R2 (``scaling-study``, ``wire-study``,
``profile-online``), the port's is held to the JAX script's on the same
numpy inputs within 0.01: the two packages' fits draw from different
random streams, and on these maps of 40-60 neurons with 4-6 connected
cells one cell's gate decision moves R2 by ~0.01 (the main map's band
is ±0.003, over ~50 connected cells); measured: 1e-4 to 6e-4. The wire
study's cut map (N=60, 600 trials) has 3 connected cells, and there the
JAX package's own truth-R2 over fit seeds 0-5 spans 0.010 (f32) to
0.036 (int4 mu-law), so its band is 0.04 (measured: 0.008 to 0.030,
the port above). Neither side's timings are compared: this is a CPU.
"""

import ast
import importlib
import importlib.util
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from cli_parity import one_host_thread  # noqa: F401 (autouse)
from circuitmap_tpu.utils import profiling as jax_profiling
from circuitmap_torch.__main__ import main as port_main
from circuitmap_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts_tpu"
R2_BAND = 0.01
WIRE_R2_BAND = 0.04


def jax_record_keys(script):
    """The string keys of the dict literals a JAX script prints or
    writes: those inside ``json.dumps``/``json.dump``/``dict(...)``
    calls and ``row = dict(...)`` rows."""
    keys = set()
    tree = ast.parse((SCRIPTS / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value,
                                                                   str)}
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "dict"):
            keys |= {kw.arg for kw in node.keywords if kw.arg}
    return keys


def run_jax_script(name, argv, monkeypatch, capsys, cwd=REPO):
    """``scripts_tpu/<name>.py``'s ``main()`` in this process, in
    ``cwd``; returns what it printed."""
    capsys.readouterr()
    path = SCRIPTS / f"{name}.py"
    with monkeypatch.context() as m:
        m.chdir(cwd)
        m.setattr(sys, "argv", [str(path), *map(str, argv)])
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        module.main()
    return capsys.readouterr().out


def run_port(argv, monkeypatch, capsys, cwd=REPO):
    capsys.readouterr()
    with monkeypatch.context() as m:
        m.chdir(cwd)
        assert port_main([*map(str, argv), "--device", "cpu"]) in (0, None)
    return capsys.readouterr().out


def _json_line(out):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith("{")))


# ------------------------------------------------------------ profiling

def test_metrics_records_equal_the_jax_class(tmp_path, monkeypatch):
    # the JAX class times with time.time, the port's with perf_counter
    clock = iter(np.arange(0.0, 100.0, 0.25))
    perf = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(perf)))
    records = []
    for cls, path in ((jax_profiling.Metrics, tmp_path / "jax.jsonl"),
                      (profiling.Metrics, tmp_path / "port.jsonl")):
        m = cls()
        with m.span("upload", bytes=12):
            pass
        m.log("fit", r2=0.99, iters=50)
        with pytest.raises(ValueError):
            with m.span("failed"):
                raise ValueError
        lines = m.dump(path)
        m.dump(path)
        records.append((m.records, lines, path.read_text()))
    assert records[0] == records[1]
    assert [r["name"] for r in records[1][0]] == ["upload", "fit", "failed"]


def test_annotate_spans_appear_in_a_cpu_trace(tmp_path):
    with profiling.trace(tmp_path) as prof:
        with profiling.annotate("cm_weight_update"):
            torch.ones(64, 64).sum()
        with profiling.annotate("cm_spike_sweep"):
            torch.ones(8).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert {"cm_weight_update", "cm_spike_sweep"} <= names
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {"cm_weight_update", "cm_spike_sweep"} <= {
        e.get("name") for e in events}


# ------------------------------------------------------------ wire-study

def _jax_wire_module():
    spec = importlib.util.spec_from_file_location(
        "_jax_wire", SCRIPTS / "wire_fidelity_study.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("bits,mulaw", [(8, False), (4, False), (4, True),
                                        (2, False)])
def test_quantise_codes_are_the_jax_scripts(bits, mulaw):
    from circuitmap_torch.scripts.wire_fidelity_study import quantise

    rng = np.random.default_rng(bits)
    psc = (rng.standard_normal((40, 900)) * rng.random((40, 1))).astype(
        np.float32)
    psc[3] = 0.0  # a silent trace: the scale guard
    got = quantise(psc, bits, mulaw)
    want = _jax_wire_module().quantise(psc, bits, mulaw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_wire_study_matches_jax(tmp_path, monkeypatch, capsys):
    """Both studies at one seed on a cut map: N=60, 600 trials (the
    protocol's 100 stimulations a neuron; the JAX script's hard-coded
    N=200 map and its ``Model(200)`` are cut with it)."""
    import circuitmap_tpu.model as jax_model
    import circuitmap_tpu.simulation as jax_sim
    import circuitmap_torch.simulation as port_sim

    def cut(simulate):
        return lambda **kw: simulate(**{**kw, "N": 60, "trials": 600})

    jax_model_cls = jax_model.Model
    monkeypatch.setattr(jax_sim, "simulate", cut(jax_sim.simulate))
    monkeypatch.setattr(jax_model, "Model", lambda n: jax_model_cls(60))
    monkeypatch.setattr(port_sim, "simulate", cut(port_sim.simulate))
    run_jax_script("wire_fidelity_study",
                   ["--seeds", 0, "--out", tmp_path / "jax.json"],
                   monkeypatch, capsys)
    out = run_port(["wire-study", "--seeds", 0, "--out",
                    tmp_path / "port.json"], monkeypatch, capsys)
    assert f"wrote {tmp_path / 'port.json'}" in out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want)
    assert [r["wire"] for r in got["rows"]] == [r["wire"] for r in
                                               want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w) == {"seed", "wire", "truth_r2"}
        assert abs(g["truth_r2"] - w["truth_r2"]) <= WIRE_R2_BAND, (g, w)
    assert set(got["summary"]) == set(want["summary"])


# ------------------------------------------------------- scaling-study

def test_scaling_study_only_rows_match_jax(tmp_path, monkeypatch, capsys):
    argv = ["--only", "60,600,4", "--only", "80,800,4", "--repeats", 1]
    run_jax_script("run_scaling_study",
                   [*argv, "--out", tmp_path / "jax.json"], monkeypatch,
                   capsys)
    # an earlier row of the output file is kept (merged by N, K, H)
    (tmp_path / "port.json").write_text(json.dumps({"results": [
        {"N": 1, "K": 2, "H": 10, "seconds": 0.0, "r2": 0.0}]}))
    out = run_port(["scaling-study", *argv, "--out", tmp_path / "port.json"],
                   monkeypatch, capsys)
    assert "| N | K | demix+fit (s) | truth R² |" in out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert set(got) == set(want)
    assert got["device"] == "cpu" and got["wire"] == want["wire"] == "int4"
    rows = {(r["N"], r["K"]): r for r in got["results"]}
    assert (1, 2) in rows
    for w in want["results"]:
        g = rows[(w["N"], w["K"])]
        assert set(g) == set(w)
        assert abs(g["r2"] - w["r2"]) <= R2_BAND, (g, w)


# ------------------------------------------------------------ profiles

def test_profile_fit_prints_the_jax_record(monkeypatch, capsys):
    from circuitmap_torch.scripts import profile_fit_entry

    monkeypatch.setattr(profile_fit_entry, "MAIN_MAP",
                        dict(N=60, K=600, iters=5))
    out = run_port(["profile-fit"], monkeypatch, capsys)
    rec = _json_line(out)
    assert jax_record_keys("profile_fit_entry.py") <= set(rec)
    assert set(rec["stages_best_ms"]) == {"observations", "stim_prep",
                                          "fit_scan", "reconnect", "pull"}
    # the fit's own spans: host ms, and the device ms of their launches
    assert set(rec["stages_device_ms"]) == set(rec["stages_best_ms"])
    assert all(v >= 0 for v in rec["stages_device_ms"].values())
    assert rec["staged_sum_ms"] == pytest.approx(
        sum(rec["stages_best_ms"].values()), abs=0.01)
    assert rec["whole_fit_ms"] > 0


def test_profile_demixer_prints_the_jax_record_and_the_split(monkeypatch,
                                                             capsys):
    out = run_port(["profile-demixer", 300], monkeypatch, capsys)
    rec = json.loads(out[out.index("{"):])
    assert {"K", "bf16", "forward_wall_ms_best", "device_total_ms",
            "top_ops_ms"} <= set(rec)
    assert jax_record_keys("profile_demixer.py") <= set(rec)
    assert rec["K"] == 300 and rec["wire"] == "int4d2"
    # int4d2: 450 codes a trace at two a byte, and a float32 scale
    assert rec["wire_bytes"] == 300 * 225 + 300 * 4
    assert any("conv" in name for name in rec["top_ops_ms"])
    for key in ("host_encode_ms", "upload_ms", "device_decode_ms",
                "demix_call_ms_best"):
        assert rec[key] >= 0


def test_profile_online_matches_jax(monkeypatch, capsys):
    jout = run_jax_script("profile_online", [40, 64, 3], monkeypatch, capsys)
    pout = run_port(["profile-online", 40, 64, 3], monkeypatch, capsys)
    want, got = _json_line(jout), _json_line(pout)
    assert set(want) <= set(got)
    for key in ("N", "block", "iters_per_update", "blocks", "trials_total"):
        assert got[key] == want[key]
    assert len(got["latency_ms_per_block"]) == 12
    assert abs(got["final_r2_vs_truth"] - want["final_r2_vs_truth"]) \
        <= R2_BAND


# ------------------------------------------------- memory-cliff, studies

def test_memory_cliff_runs_one_tiny_rung(tmp_path, monkeypatch, capsys):
    from circuitmap_torch.scripts import probe_memory_cliff as mc

    monkeypatch.setattr(mc, "FIRST_RUNG", (40, 400))
    out = run_port(["memory-cliff", "--quick", "--out",
                    tmp_path / "cliff.json"], monkeypatch, capsys)
    assert out.startswith("probe N=40 K=400 (0.0 GB per [N,K] array)...")
    data = json.loads((tmp_path / "cliff.json").read_text())
    assert set(data) == {"device", "protocol", "results"}
    assert data["device"] == "cpu"
    (row,) = data["results"]
    assert row["ok"] is True and row["peak_device_gb"] is None
    assert {"N", "K", "gb_per_array", "wall_seconds", "ok",
            "seconds"} <= set(row)


def test_memory_cliff_ladder_walks_to_the_cards_cliff(monkeypatch):
    """The ladder's legs on a stand-in probe: N doubles; a host-side
    stop (here above N=32,766) turns to K at the last N that fit; two
    rungs bisect to the card's out-of-memory."""
    from circuitmap_torch.scripts import probe_memory_cliff as mc

    def probe(N, K, device, timeout):
        if N > 32766:
            return dict(N=N, K=K, ok=False, oom=False, host_oom=True)
        return dict(N=N, K=K, ok=N * K <= 3.6e9, oom=N * K > 3.6e9,
                    host_oom=False)

    monkeypatch.setattr(mc, "probe", probe)
    rows = [(r["N"], r["K"], r["ok"]) for r in mc.ladder("cuda", 1, False)]
    assert rows == [(2000, 100000, True), (4000, 100000, True),
                    (8000, 100000, True), (16000, 100000, True),
                    (32000, 100000, True), (64000, 100000, False),
                    (32000, 125000, False), (32000, 112500, True),
                    (32000, 118750, False)]


def test_compile_study_records_both_modes(tmp_path, monkeypatch, capsys):
    from circuitmap_torch.scripts import measure_many_compile as mmc

    monkeypatch.setattr(mmc, "SIZE", dict(B=2, N=20, K=200, iters=3))
    out = run_port(["compile-study", "--out", tmp_path / "cs.json"],
                   monkeypatch, capsys)
    assert f"wrote {tmp_path / 'cs.json'}" in out
    data = json.loads((tmp_path / "cs.json").read_text())
    assert set(data) == {"config", "results"}
    assert [r["mode"] for r in data["results"]] == ["sequential", "batched"]
    for r in data["results"]:
        assert {"mode", "cold_s", "warm_s", "times", "wall_s"} <= set(r)
        assert len(r["times"]) == 4 and r["warm_s"] == r["times"][1]


@pytest.mark.parametrize("command,default", [
    ("memory-cliff", "MEMORY_CLIFF_H100.json"),
    ("scaling-study", "SCALING_H100.json"),
    ("wire-study", "WIRE_STUDY_H100.json"),
    ("compile-study", "COMPILE_STUDY_H100.json"),
])
def test_studies_never_default_to_the_tpu_records(command, default, capsys):
    with pytest.raises(SystemExit):
        port_main([command, "--help"])
    text = " ".join(capsys.readouterr().out.split())
    module = __import__("circuitmap_torch.__main__", fromlist=["_COMMANDS"])
    mod = importlib.import_module(
        f"circuitmap_torch.scripts.{module._COMMANDS[command]}")
    src = Path(mod.__file__).read_text()
    assert default in src and "--out" in text
    assert f'"{default.replace("_H100", "")}"' not in src


# ------------------------------------------------- the envelope preflight

def test_envelope_arithmetic_and_silence_on_the_cpu(monkeypatch):
    from circuitmap_torch.solvers import _common

    cliff = _common._SINGLE_CARD_ELEM_CLIFF
    n = int(cliff // 100000)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # at the cliff, on the CPU, and any size on the CPU: silent
        _common.warn_single_chip_envelope(n, 100000, device="cuda")
        _common.warn_single_chip_envelope(10 * n, 100000, device="cpu")
        _common.warn_single_chip_envelope(10 * n, 100000,
                                          device=torch.device("cpu"))
    # past it on a CUDA device (named, or None: the GPU by default); no
    # CUDA call is made, so this runs without a card
    for dev in ("cuda", "cuda:0", None):
        with pytest.warns(_common.MemoryEnvelopeWarning, match="caviar"):
            _common.warn_single_chip_envelope(n + 10, 100000,
                                              what="caviar()", device=dev)
    # float64 reaches the cliff at half the elements
    with pytest.warns(_common.MemoryEnvelopeWarning,
                      match="float32-equivalent"):
        _common.warn_single_chip_envelope(n // 2 + 10, 100000,
                                          dtype=torch.float64, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _common.warn_single_chip_envelope(n // 2 - 10, 100000,
                                          dtype="float64", device="cuda")
    assert issubclass(_common.MemoryEnvelopeWarning, ResourceWarning)


def test_envelope_cliff_is_the_measured_one():
    from circuitmap_torch.solvers import _common

    data = json.loads((REPO / "MEMORY_CLIFF_H100.json").read_text())
    assert "H100" in data["device"] and "W" in data["device"]
    fits = [r["N"] * r["K"] for r in data["results"] if r["ok"]]
    assert _common._SINGLE_CARD_ELEM_CLIFF == max(fits)
    assert any(r.get("oom") for r in data["results"])


SITES = ["caviar", "caviar_resumable", "cavi_sns", "mbcs", "caviar_many",
         "sns_many", "mbcs_many"]


@pytest.mark.parametrize("site", SITES)
def test_each_single_card_entry_runs_the_preflight(site, tmp_path,
                                                   monkeypatch):
    import circuitmap_torch as cm

    calls = []

    def record(n_rows, k, what="this fit", dtype=None, device=None):
        calls.append((n_rows, k, what, device))

    for name in ("batched", "caviar", "cavi_sns", "mbcs", "resumable"):
        module = importlib.import_module(f"circuitmap_torch.solvers.{name}")
        monkeypatch.setattr(module, "warn_single_chip_envelope", record)
    np.random.seed(1)
    sim = cm.simulate(N=12, trials=120, H=2, connection_prob=0.3,
                      verbose=False, device="cpu")
    p = cm.default_priors(12)
    psc, stim = sim["psc"], sim["stim_matrix"]
    two = (np.stack([psc, psc]), np.stack([stim, stim]))
    kw = dict(verbose=False, device="cpu")
    run = {
        "caviar": lambda: cm.caviar(psc, stim, p["mu"], p["beta"],
                                    p["shape"], p["rate"], p["phi"],
                                    p["phi_cov"], iters=2, **kw),
        "caviar_resumable": lambda: cm.caviar_resumable(
            psc, stim, p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
            p["phi_cov"], str(tmp_path / "r.npz"), iters=2, **kw),
        "cavi_sns": lambda: cm.cavi_sns(psc, stim, p["mu"], p["beta"],
                                        p["alpha"], p["shape"], p["rate"],
                                        p["phi"], p["phi_cov"], iters=2,
                                        **kw),
        "mbcs": lambda: cm.mbcs(psc, stim, p["mu"], p["beta"], p["shape"],
                                p["rate"], iters=2, device="cpu"),
        "caviar_many": lambda: cm.caviar_many(
            *two, p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
            p["phi_cov"], iters=2, **kw),
        "sns_many": lambda: cm.sns_many(
            *two, p["mu"], p["beta"], p["alpha"], p["shape"], p["rate"],
            p["phi"], p["phi_cov"], iters=2, **kw),
        "mbcs_many": lambda: cm.mbcs_many(
            *two, p["mu"], p["beta"], p["shape"], p["rate"], iters=2, **kw),
    }
    run[site]()
    assert len(calls) == 1, calls
    n_rows, k, what, device = calls[0]
    assert what.startswith(site + "()")
    assert k == 120 and n_rows == (24 if site.endswith("_many") else 12)
    assert torch.device(device).type == "cpu"
