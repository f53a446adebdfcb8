"""The port's spans (``circuitmap_torch/utils/profiling.py``) on the CPU.

Held: a fit under ``torch.profiler`` shows each of its ``cm.fit.*``
stages inside ``cm.fit``, once (the stim stage twice), and an int4d2 demix one ``cm.wire.encode``
and one ``cm.demix.net`` a chunk inside ``cm.demix``; every ``cm.*``
span exports as a host ``cpu_op`` (a ``user_annotation`` is what the
profiler mirrors onto the device timeline); a fit under the profiler
equals one without it bit for bit; the fit server's request log gives
each request its stages, and the fit client's calls show their encode
and decode; a batched ``caviar_many`` opens ``cm.many`` and its four
stages in order.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
from http.server import HTTPServer

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import circuitmap_torch as cm
from circuitmap_torch import serve as ts
from circuitmap_torch.demix.demixer import NeuralDemixer
from circuitmap_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMIXER = os.path.join(REPO, "demixers", "nwd_ie_ChroME2f_int4d2qat.npz")
N, K = 20, 200
FIT_OPTS = dict(iters=4, msrmp=0.3, num_mc_samples=10, seed=5,
                verbose=False)
FIT_STAGES = ("cm.fit.traces", "cm.fit.stim", "cm.fit.loop", "cm.fit.scan",
              "cm.fit.pull")
# the stim stage opens before the traces' stage (the host sparsify) and
# after it (the upload, once the observations' mask is known)
FIT_ORDER = ("cm.fit.stim", "cm.fit.traces", "cm.fit.stim", "cm.fit.loop",
             "cm.fit.scan", "cm.fit.pull")


@pytest.fixture(scope="module")
def sim():
    np.random.seed(11)
    return cm.simulate(N=N, trials=K, H=3, connection_prob=0.2,
                       verbose=False, device="cpu")


@pytest.fixture(scope="module")
def demixer():
    return NeuralDemixer(DEMIXER, device="cpu")


def _fit(sim):
    return cm.Model(N).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                           fit_options=dict(FIT_OPTS))


def _cm_events(prof):
    return [e for e in prof.events() if e.name.startswith("cm.")]


@pytest.fixture(scope="module")
def fit_trace(sim, tmp_path_factory):
    """One fit under the profiler: (its cm.* events, the exported Chrome
    trace's events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(sim)
    path = tmp_path_factory.mktemp("trace") / "fit.json"
    prof.export_chrome_trace(str(path))
    return _cm_events(prof), json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("name", FIT_STAGES)
def test_each_fit_stage_is_one_span_inside_the_fit(fit_trace, name):
    events, _ = fit_trace
    (fit,) = [e for e in events if e.name == "cm.fit"]
    stages = [e for e in events if e.name == name]
    assert len(stages) == FIT_ORDER.count(name)
    for stage in stages:
        assert stage.cpu_parent is not None \
            and stage.cpu_parent.name == "cm.fit"
        assert fit.time_range.start <= stage.time_range.start
        assert stage.time_range.end <= fit.time_range.end


def test_fit_stages_run_in_order(fit_trace):
    events, _ = fit_trace
    stages = sorted((e for e in events if e.name in FIT_STAGES),
                    key=lambda e: e.time_range.start)
    assert tuple(e.name for e in stages) == FIT_ORDER
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start


@pytest.mark.parametrize("chunk_size,chunks", [(64, 4), (4096, 1)])
def test_a_demix_shows_one_encode_and_one_net_a_chunk(sim, demixer,
                                                      chunk_size, chunks):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        demixer(sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
                verbose=False, chunk_size=chunk_size)
    events = _cm_events(prof)
    (call,) = [e for e in events if e.name == "cm.demix"]
    for name in ("cm.wire.encode", "cm.demix.net"):
        inner = [e for e in events if e.name == name]
        assert len(inner) == chunks, name
        assert all(e.cpu_parent is call for e in inner), name
    # each chunk is encoded, then run through the network
    order = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
             if e.name != "cm.demix"]
    assert order == ["cm.wire.encode", "cm.demix.net"] * chunks


def test_the_fits_raw_trace_wire_encodes_inside_its_traces_stage(sim):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cm.Model(N).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                        fit_options=dict(FIT_OPTS, trace_wire="int8"))
    (enc,) = [e for e in _cm_events(prof) if e.name == "cm.wire.encode"]
    assert enc.cpu_parent.name == "cm.fit.traces"


@pytest.mark.parametrize("name", ("cm.fit",) + FIT_STAGES)
def test_spans_export_as_host_ops(fit_trace, name):
    """A ``user_annotation`` is mirrored onto the device timeline once a
    card is traced; a ``cpu_op`` is not."""
    _, chrome = fit_trace
    cats = {e.get("cat") for e in chrome if e.get("name") == name}
    assert cats == {"cpu_op"}


def test_a_fit_under_the_profiler_equals_one_without(sim):
    plain = _fit(sim).state
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _fit(sim).state
    for key, want in plain.items():
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(traced[key], want, err_msg=key)


MANY_ORDER = ("cm.many.stim", "cm.many.loop", "cm.many.scan",
              "cm.many.pull")


def test_a_batched_fit_opens_its_spans_in_order_and_never_syncs(
        sim, monkeypatch, tmp_path):
    """``caviar_many``: one ``cm.many`` holding its four stages once each,
    in order, each a host ``cpu_op``; no span waits on the device, and
    the fits under the profiler equal those without it."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    p = cm.default_priors(N)
    args = (np.stack([sim["psc"][:100], sim["psc"][100:]]),
            np.stack([sim["stim_matrix"][:, :100],
                      sim["stim_matrix"][:, 100:]]),
            p["mu"], p["beta"], p["shape"], p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=4, compile_mode="batched", update_order="identity",
              analytic_mc=True, device="cpu", verbose=False)
    plain = cm.caviar_many(*args, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = cm.caviar_many(*args, **kw)
    events = _cm_events(prof)
    (call,) = [e for e in events if e.name == "cm.many"]
    stages = sorted((e for e in events if e.name in MANY_ORDER),
                    key=lambda e: e.time_range.start)
    assert tuple(e.name for e in stages) == MANY_ORDER
    assert all(e.cpu_parent is call for e in stages)
    for a, b in zip(stages, stages[1:]):
        assert a.time_range.end <= b.time_range.start
    path = tmp_path / "many.json"
    prof.export_chrome_trace(str(path))
    cats = {e.get("cat") for e in json.loads(path.read_text())["traceEvents"]
            if e.get("name", "").startswith("cm.many")}
    assert cats == {"cpu_op"}
    assert syncs == []
    for got, want in zip(traced, plain):
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# ------------------------------------------------------------- span()

def test_span_records_host_seconds_in_metrics_also_when_it_raises():
    m = profiling.Metrics()
    with profiling.span("cm.a", m):
        pass
    with pytest.raises(KeyError):
        with profiling.span("cm.b", m, rows=3):
            raise KeyError
    assert [r["name"] for r in m.records] == ["cm.a", "cm.b"]
    assert m.records[1]["rows"] == 3
    assert all(r["seconds"] >= 0 for r in m.records)


def test_the_fit_client_encodes_without_importing_torch():
    code = ("import sys; import numpy as np; "
            "from circuitmap_torch.serve import FitClient; "
            "FitClient._body(np.ones((4, 10)), np.eye(3, 4) * 45.0, True, "
            "'f16'); print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


# ------------------------------------------------------------ serving

@contextlib.contextmanager
def served(log_path):
    svc = ts.FitService(demixer_path=DEMIXER, device="cpu")
    svc.metrics_fh = open(log_path, "w")
    box = [None]
    httpd = HTTPServer(("127.0.0.1", 0), ts._make_handler(svc, box))
    box[0] = httpd
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield ts.FitClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        svc.metrics_fh.close()


ENDPOINT_STAGES = {
    "/fit": {"read", "decode", "demix", "fit", "encode", "write"},
    "/demix": {"read", "decode", "demix", "encode", "write"},
    "/fit_many": {"read", "decode", "demix", "fit", "encode", "write"},
    "/health": {"write"},
    "/fit_many (ragged)": {"read", "decode", "demix", "fit", "encode",
                           "write"},
    "/stream/<name>/update": {"read", "decode", "demix", "fit", "encode",
                              "write"},
}


@pytest.fixture(scope="module")
def request_log(sim, tmp_path_factory):
    """One request to each endpoint of ``ENDPOINT_STAGES`` and the
    client's spans of its ``/fit``: ({endpoint: log row}, cm.*
    events)."""
    path = tmp_path_factory.mktemp("serve") / "requests.jsonl"
    opts = dict(FIT_OPTS)
    opts.pop("verbose")
    psc, stim = sim["psc"], sim["stim_matrix"]
    with served(path) as client:
        client.health()
        client.demix(psc[:50], psc_wire="int4d2", trace_wire="int4d2")
        client.fit_many(np.stack([psc, psc]), np.stack([stim, stim]),
                        psc_wire="int4d2", trace_wire="int4d2", iters=3)
        client.fit_many([psc[:80], psc[80:]], [stim[:, :80], stim[:, 80:]],
                        psc_wire="int4d2", trace_wire="int4d2", iters=3)
        client.stream_update("rig/1", psc[:100], stim[:, :100], iters=2,
                             psc_wire="int4d2", trace_wire="int4d2")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            client.fit(psc, stim, psc_wire="int4d2", trace_wire="int4d2",
                       response_wire="int8", **opts)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    endpoints = ["/health", "/demix", "/fit_many", "/fit_many (ragged)",
                 "/stream/<name>/update", "/fit"]
    assert [r["path"] for r in rows] == [
        "/health", "/demix", "/fit_many", "/fit_many",
        "/stream/rig%2F1/update", "/fit"]
    return dict(zip(endpoints, rows)), _cm_events(prof)


@pytest.mark.parametrize("endpoint", sorted(ENDPOINT_STAGES))
def test_request_log_rows_carry_their_stages(request_log, endpoint):
    rows, _ = request_log
    row = rows[endpoint]
    assert row["status"] == 200
    assert set(row["stages"]) == ENDPOINT_STAGES[endpoint]
    assert all(v >= 0 for v in row["stages"].values())
    # the row's seconds are rounded to 0.1 ms, the stages to 1 us
    assert sum(row["stages"].values()) <= row["seconds"] + 5e-5 + 1e-5
    assert {"ts", "method", "seconds", "bytes_in", "bytes_out"} <= set(row)


@pytest.mark.parametrize("name", ["cm.client.encode", "cm.client.decode"])
def test_the_fit_client_shows_its_encode_and_decode(request_log, name):
    _, events = request_log
    assert len([e for e in events if e.name == name]) == 1
