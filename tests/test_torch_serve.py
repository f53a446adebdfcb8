"""The port's fit server (``circuitmap_torch.serve``) on the CPU.

In-process servers on port 0 (``FitService`` behind ``_make_handler`` on
a thread), at N=30, K=300. What is held:

* a served ``/fit``, ``/fit_many`` (stacked and ragged, each method) and
  a 3-block stream equal the port's in-process ``Model.fit``,
  ``caviar_many``/``sns_many``/``mbcs_many`` and ``OnlineCaviar``
  (rtol 1e-6);
* the JAX package's server on the same body returns the same keys,
  shapes and dtypes, and recovers the weights as well (truth-R² within
  0.02; the float32 fits of the two packages can part at a gate, so the
  tight hold is the float64 one of ``tests/test_torch_caviar.py``);
* each package's ``FitClient`` drives the other package's server;
* every client error of the JAX package's ``TestServiceUnit`` that has a
  counterpart is a 400 here too; the profiler, the status sidecar, the
  watchdog and the client's retries behave as the JAX package's do.
"""

import contextlib
import json
import os
import threading
import time
from http.server import HTTPServer

import numpy as np
import pytest
import torch

from circuitmap_torch import serve as ts
from circuitmap_torch.utils.metrics import r2_score

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMIXER = os.path.join(REPO, "demixers", "nwd_ie_ChroME2f.npz")
N, K = 30, 300
FIT_OPTS = dict(iters=6, msrmp=0.3, num_mc_samples=20, seed=11)
CPU = torch.device("cpu")


@contextlib.contextmanager
def loopback(service, make_handler):
    """``service`` behind the HTTP handler on 127.0.0.1:<free port>;
    yields the base URL."""
    box = [None]
    httpd = HTTPServer(("127.0.0.1", 0), make_handler(service, box))
    box[0] = httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def sim():
    import circuitmap_torch as cm

    np.random.seed(3)
    return cm.simulate(N=N, trials=K, H=4, connection_prob=0.2,
                       verbose=False, device="cpu")


@pytest.fixture(scope="module")
def svc():
    return ts.FitService(demixer_path=DEMIXER, device="cpu")


@pytest.fixture(scope="module")
def port_url(svc):
    with loopback(svc, ts._make_handler) as url:
        yield url


@pytest.fixture(scope="module")
def jax_url():
    from circuitmap_tpu import serve as js

    with loopback(js.FitService(demixer_path=DEMIXER),
                  js._make_handler) as url:
        yield url


def _load(payload):
    return ts._load_npz(payload[1])


def assert_same_fit(got, want, keys=None, rtol=1e-6):
    keys = sorted(want) if keys is None else keys
    for key in keys:
        a = np.asarray(got[key], np.float64)
        b = np.asarray(want[key], np.float64)
        assert a.shape == b.shape, key
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=key)


def _priors():
    from circuitmap_torch import default_priors

    return default_priors(N)


# ------------------------------------------------ served == in-process


METHOD_OPTS = {
    "caviar": FIT_OPTS,
    "cavi_sns": dict(iters=4, num_mc_samples=10, seed=2),
    "mbcs": dict(iters=4, seed=2),
    "cosamp": dict(k=6),
}


@pytest.mark.parametrize("method", sorted(METHOD_OPTS))
def test_served_fit_equals_the_local_fit(port_url, sim, method):
    from circuitmap_torch import Model

    opts = METHOD_OPTS[method]
    cli = ts.FitClient(port_url)
    got = cli.fit(sim["psc"], sim["stim_matrix"], method=method,
                  demix=False, **opts)
    local = dict(opts) if method == "cosamp" else dict(opts, verbose=False)
    model = Model(N).fit(sim["psc"], sim["stim_matrix"], method=method,
                         fit_options=local, device="cpu")
    want = {k: v for k, v in model.state.items()
            if isinstance(v, np.ndarray)}
    want.update({f"history_{k}": v for k, v in model.history.items()
                 if v is not None})
    assert sorted(set(got) - {"fit_time_s"}) == sorted(want)
    assert_same_fit(got, want)


def test_int4d2_body_with_demix_equals_the_local_wire_chain(svc, sim):
    from circuitmap_torch import Model
    from circuitmap_torch.demix.demixer import NeuralDemixer

    body = ts._npz_bytes(stim=sim["stim_matrix"],
                         **ts._encode_psc(sim["psc"], "int4d2"))
    n_demixes = svc.n_demixes
    got = _load(svc.do_fit(body, json.dumps(
        dict(FIT_OPTS, demix=True, trace_wire="int4d2"))))
    assert svc.n_demixes == n_demixes + 1
    dem = NeuralDemixer(DEMIXER, device="cpu")(
        sim["psc"], verbose=False, keep_on_device=True,
        transfer_dtype="int4d2")
    model = Model(N).fit(dem, sim["stim_matrix"],
                         fit_options=dict(FIT_OPTS, verbose=False),
                         device="cpu")
    assert_same_fit(got, model.state, ["mu", "beta", "lam", "phi",
                                       "phi_cov", "z", "shape", "rate"])


def test_int4_body_reaches_the_solver_as_its_codes(svc, sim):
    """No host decode and encode: an int4 body fits as the in-process
    int4 trace wire fits the raw traces; the sparse stim body fits as
    the dense one."""
    from circuitmap_torch import Model

    opts = json.dumps(dict(FIT_OPTS, demix=False))
    psc, stim = sim["psc"], sim["stim_matrix"]
    got = _load(svc.do_fit(ts._npz_bytes(stim=stim, **ts._encode_psc(
        psc, "int4")), opts))
    model = Model(N).fit(psc, stim, device="cpu", fit_options=dict(
        FIT_OPTS, trace_wire="int4", verbose=False))
    assert_same_fit(got, model.state, ["mu", "lam", "phi"])
    dense = _load(svc.do_fit(ts._npz_bytes(psc=psc, stim=stim), opts))
    sparse = _load(svc.do_fit(ts._npz_bytes(
        psc=psc, **ts.encode_stim_sparse(stim)), opts))
    assert set(dense) == set(sparse)
    for key in set(dense) - {"fit_time_s"}:
        assert np.array_equal(dense[key], sparse[key]), key


MANY_OPTS = {
    "caviar": dict(iters=4, seeds=[1, 2], num_mc_samples=10),
    "cavi_sns": dict(iters=3, seeds=[1, 2], num_mc_samples=10,
                     analytic_mc=True),
    "mbcs": dict(iters=3, seeds=[1, 2], analytic_noise=True),
}


def _library_many(method, ys, stims, **kw):
    from circuitmap_torch import caviar_many, mbcs_many, sns_many

    p = _priors()
    if method == "caviar":
        return caviar_many(ys, stims, p["mu"], p["beta"], p["shape"],
                           p["rate"], p["phi"], p["phi_cov"],
                           verbose=False, device="cpu", **kw)
    if method == "cavi_sns":
        return sns_many(ys, stims, p["mu"], p["beta"], p["alpha"],
                        p["shape"], p["rate"], p["phi"], p["phi_cov"],
                        verbose=False, device="cpu", **kw)
    return mbcs_many(ys, stims, p["mu"], p["beta"], p["shape"], p["rate"],
                     verbose=False, device="cpu", **kw)


@pytest.mark.parametrize("form", ["stacked", "ragged"])
@pytest.mark.parametrize("method", sorted(MANY_OPTS))
def test_served_fit_many_equals_the_library(port_url, sim, method, form):
    opts = MANY_OPTS[method]
    cli = ts.FitClient(port_url)
    psc, stim = sim["psc"], sim["stim_matrix"]
    if form == "stacked":
        pscs = np.stack([psc[:150], psc[150:]])
        stims = np.stack([stim[:, :150], stim[:, 150:]])
        got = cli.fit_many(pscs, stims, method=method, demix=False, **opts)
        want = _library_many(method, pscs, stims, **opts)
        assert sorted(got) == sorted(want[0])
        for b in range(2):
            assert_same_fit({k: v[b] for k, v in got.items()}, want[b])
        return
    ks = [120, 180]
    pscs, stims = [psc[:120], psc[120:]], [stim[:, :120], stim[:, 120:]]
    got = cli.fit_many(pscs, stims, method=method, demix=False, **opts)
    if method == "caviar":
        # the server pads to one 128-aligned width and fits with k_trues
        y_pad = np.zeros((2, 256, psc.shape[1]))
        s_pad = np.zeros((2, N, 256))
        for b, k in enumerate(ks):
            y_pad[b, :k], s_pad[b, :, :k] = pscs[b], stims[b]
        want = _library_many(method, y_pad, s_pad, k_trues=ks, **opts)
    else:
        want = _library_many(method, pscs, stims, **opts)
    assert isinstance(got, list) and len(got) == 2
    for b in range(2):
        assert sorted(got[b]) == sorted(want[b])
        assert got[b]["lam"].shape == (N, ks[b])
        assert_same_fit(got[b], want[b])


def test_fit_many_demixes_the_batch_in_one_call(svc, sim):
    from circuitmap_torch.demix.demixer import NeuralDemixer

    pscs = np.stack([sim["psc"][:150], sim["psc"][150:]])
    stims = np.stack([sim["stim_matrix"][:, :150],
                      sim["stim_matrix"][:, 150:]])
    opts = dict(MANY_OPTS["caviar"], trace_wire="int8")
    n_demixes = svc.n_demixes
    got = _load(svc.do_fit_many(ts._npz_bytes(pscs=pscs, stims=stims),
                                json.dumps(dict(opts, demix=True))))
    assert svc.n_demixes == n_demixes + 1  # one flattened call, not B
    flat = NeuralDemixer(DEMIXER, device="cpu")(
        pscs.reshape(300, -1), verbose=False, keep_on_device=True,
        transfer_dtype="int8")
    opts.pop("trace_wire")
    want = _library_many("caviar", flat.reshape(2, 150, -1), stims, **opts)
    for b in range(2):
        assert_same_fit({k: v[b] for k, v in got.items()}, want[b])
    # an int4d2 stack stays packed to the device and fits as its decode
    enc = {"pscs" + k[len("psc"):]: v
           for k, v in ts._encode_psc(pscs, "int4d2").items()}
    body = ts._decode_arrays(ts._load_npz(ts._npz_bytes(**enc)))["pscs"]
    a = _load(svc.do_fit_many(ts._npz_bytes(stims=stims, **enc),
                              json.dumps(dict(opts, demix=False))))
    b = _load(svc.do_fit_many(ts._npz_bytes(stims=stims, pscs=body.dense()),
                              json.dumps(dict(opts, demix=False))))
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def test_served_stream_equals_online_caviar(port_url, sim):
    from circuitmap_torch import OnlineCaviar

    cli = ts.FitClient(port_url)
    create = {"powers": [45.0, 55.0, 65.0], "analytic_mc": True, "seed": 4}
    local = OnlineCaviar(N, device="cpu", **create)
    for i in range(3):
        sl = slice(100 * i, 100 * (i + 1))
        reply = cli.stream_update(
            "s3", sim["psc"][sl], sim["stim_matrix"][:, sl], iters=4,
            create=create if i == 0 else None, demix=False)
        local.update(sim["psc"][sl], sim["stim_matrix"][:, sl], iters=4)
        assert reply["trial_count"] == 100 * (i + 1)
        assert reply["iterations"] == 4 * (i + 1)
        assert reply["reconnected"] == local.last_reconnected
    assert cli.health()["streams"]["s3"] == {"trials": 300,
                                             "iterations": 12}
    assert_same_fit(cli.stream_posterior("s3"), local.posterior())
    got, want = cli.stream_result("s3"), local.result()
    assert sorted(got) == sorted(want)
    assert_same_fit(got, want)
    assert cli.stream_delete("s3") == {"deleted": "s3"}


# ------------------------------------- against the JAX package's server


def test_jax_server_returns_the_same_fields(port_url, jax_url, sim):
    opts = dict(iters=20, msrmp=0.3, seed=11, num_mc_samples=20,
                update_order="identity", analytic_mc=True)
    ours = ts.FitClient(port_url).fit(sim["psc"], sim["stim_matrix"],
                                      demix=False, **opts)
    theirs = ts.FitClient(jax_url).fit(sim["psc"], sim["stim_matrix"],
                                       demix=False, **opts)
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert (a.shape, a.dtype) == (b.shape, b.dtype), key
    r_ours = r2_score(sim["weights"], ours["mu"])
    r_theirs = r2_score(sim["weights"], theirs["mu"])
    assert r_ours > 0.8 and abs(r_ours - r_theirs) <= 0.02


def _cross_client_round(cli, sim, name):
    """health, fit, ragged fit_many, a 2-block stream and demix through
    ``cli``; returns what came back."""
    out = {"health": cli.health()}
    out["fit"] = cli.fit(sim["psc"], sim["stim_matrix"], demix=False,
                         **FIT_OPTS)
    out["many"] = cli.fit_many(
        [sim["psc"][:120], sim["psc"][120:]],
        [sim["stim_matrix"][:, :120], sim["stim_matrix"][:, 120:]],
        demix=False, psc_wire="int4", **MANY_OPTS["caviar"])
    for i in range(2):
        sl = slice(150 * i, 150 * (i + 1))
        out[f"update{i}"] = cli.stream_update(
            name, sim["psc"][sl], sim["stim_matrix"][:, sl], iters=3,
            demix=False, create={"analytic_mc": True} if i == 0 else None)
    out["result"] = cli.stream_result(name)
    cli.stream_delete(name)
    out["demix"] = cli.demix(sim["psc"][:20], psc_wire="int4",
                             response_wire="int8")
    return out


def _same_round(a, b):
    assert_same_fit(a["fit"], b["fit"], sorted(set(b["fit"]) -
                                               {"fit_time_s"}))
    for x, y in zip(a["many"], b["many"]):
        assert sorted(x) == sorted(y)
        assert_same_fit(x, y)
    for i in range(2):
        a[f"update{i}"].pop("stream")
        b[f"update{i}"].pop("stream")
        assert a[f"update{i}"] == b[f"update{i}"]
    assert_same_fit(a["result"], b["result"])
    assert a["demix"].dtype == np.float32
    assert np.array_equal(a["demix"], b["demix"])


def test_jax_client_drives_the_port_server(port_url, sim):
    from circuitmap_tpu.serve import FitClient as JaxClient

    theirs = _cross_client_round(JaxClient(port_url), sim, "jc")
    ours = _cross_client_round(ts.FitClient(port_url), sim, "pc")
    assert theirs["health"]["platform"] == "cpu"
    assert theirs["many"][1]["lam"].shape == (N, 180)
    _same_round(theirs, ours)


def test_port_client_drives_the_jax_server(jax_url, sim):
    from circuitmap_tpu.serve import FitClient as JaxClient

    ours = _cross_client_round(ts.FitClient(jax_url), sim, "pc")
    theirs = _cross_client_round(JaxClient(jax_url), sim, "jc")
    assert ours["health"]["platform"] == "cpu"
    assert ours["many"][0]["lam"].shape == (N, 120)
    _same_round(ours, theirs)
    r2 = r2_score(sim["weights"], ours["fit"]["mu"])
    assert np.isfinite(r2)


# ------------------------------------------------------------ client errors


def _body(sim, k=64, **extra):
    return ts._npz_bytes(psc=sim["psc"][:k], stim=sim["stim_matrix"][:, :k],
                         **extra)


def test_bad_npz_and_options_are_client_errors(svc, sim):
    with pytest.raises(ts._BadRequest, match="readable .npz"):
        svc.do_fit(b"not an npz", None)
    with pytest.raises(ts._BadRequest, match="valid JSON"):
        svc.do_fit(b"", "{nope")
    with pytest.raises(ts._BadRequest, match="JSON object"):
        svc.do_fit(b"", "[1]")
    body = _body(sim)
    for call in (lambda o: svc.do_fit(body, o),
                 lambda o: svc.do_fit_many(body, o),
                 lambda o: svc.do_stream_update("u", body, o),
                 lambda o: svc.do_stream_design("u", o),
                 lambda o: svc.do_warm(o),
                 lambda o: svc.do_profile(o)):
        with pytest.raises(ts._BadRequest, match="unknown .*option"):
            call(json.dumps({"no_such_knob": 1}))
    with pytest.raises(ts._BadRequest, match="unknown method"):
        svc.do_fit(body, json.dumps({"method": "lasso"}))
    with pytest.raises(ts._BadRequest, match="psc carries"):
        svc.do_fit(ts._npz_bytes(psc=sim["psc"][:10],
                                 stim=sim["stim_matrix"][:, :12]), None)
    with pytest.raises(ts._BadRequest, match="rejected the request"):
        svc.do_fit(body, json.dumps({"demix": False, "method": "mbcs",
                                     "msrmp": 0.3}))
    with pytest.raises(ts._BadRequest, match="shapes"):
        svc.do_warm(None)
    plain = ts.FitService(device="cpu")
    with pytest.raises(ts._BadRequest, match="demix"):
        plain.do_fit(body, json.dumps({"demix": True}))
    with pytest.raises(ts._BadRequest, match="without a demixer"):
        plain.do_demix(ts._npz_bytes(psc=sim["psc"][:4]), None)


def test_wire_tokens_are_validated(svc):
    from circuitmap_torch.demix.demixer import resolve_transfer_dtype

    assert svc._wire_token({"trace_wire": "int8"}) is np.int8
    assert svc._wire_token({"trace_wire": "f32"}) is None
    assert svc._wire_token({}) is None
    with pytest.raises(ts._BadRequest, match="trace wire"):
        svc._wire_token({"trace_wire": "int2"})
    assert resolve_transfer_dtype("float32") is None
    assert resolve_transfer_dtype("f16") is np.float16
    assert resolve_transfer_dtype("int4d2") == "int4d2"


def test_nonfinite_and_non_numeric_bodies_are_client_errors(svc, sim):
    psc = np.array(sim["psc"][:64])
    psc[3, 10] = np.nan
    stim = np.array(sim["stim_matrix"][:, :64])
    bad_stim = stim.copy()
    bad_stim[0, 0] = np.inf
    opts = json.dumps({"iters": 2, "demix": False})
    for call in (
            lambda: svc.do_fit(ts._npz_bytes(psc=psc, stim=stim), opts),
            lambda: svc.do_fit(ts._npz_bytes(psc=sim["psc"][:64],
                                             stim=bad_stim), opts),
            lambda: svc.do_fit_many(ts._npz_bytes(
                pscs=np.stack([psc] * 2), stims=np.stack([stim] * 2)),
                opts),
            lambda: svc.do_fit_many(ts._npz_bytes(
                psc=psc, stim=stim, k_trues=np.asarray([32, 32], np.int32)),
                opts),
            lambda: svc.do_stream_update(
                "nan", ts._npz_bytes(psc=psc, stim=stim), opts),
            lambda: svc.do_demix(ts._npz_bytes(psc=psc), None)):
        with pytest.raises(ts._BadRequest, match="non-finite"):
            call()
    assert "nan" not in svc.streams  # nothing half-created
    with pytest.raises(ts._BadRequest, match="numeric"):
        svc.do_fit(ts._npz_bytes(psc=np.array([["a", "b"], ["c", "d"]]),
                                 stim=np.zeros((2, 2))), opts)
    enc = ts.encode_stim_sparse(stim)
    enc["stim_sparse_levels"] = np.full(len(enc["stim_sparse_levels"]),
                                        np.nan)
    with pytest.raises(ts._BadRequest, match="finite"):
        svc.do_fit(ts._npz_bytes(psc=sim["psc"][:64], **enc), opts)


def test_ragged_bodies_are_validated(svc, sim):
    cat, flat = sim["psc"][:160], sim["stim_matrix"][:, :160]
    opts = json.dumps({"iters": 2, "demix": False})
    with pytest.raises(ts._BadRequest, match="positive integer"):
        svc.do_fit_many(ts._npz_bytes(psc=cat, stim=flat, k_trues=np.asarray(
            [64.0, 96.0])), opts)
    with pytest.raises(ts._BadRequest, match="sum"):
        svc.do_fit_many(ts._npz_bytes(psc=cat, stim=flat, k_trues=np.asarray(
            [64, 64], np.int32)), opts)
    with pytest.raises(ts._BadRequest, match="ragged fit_many"):
        svc.do_fit_many(ts._npz_bytes(psc=cat, k_trues=np.asarray(
            [64, 96], np.int32)), opts)
    # one giant and many tiny experiments must not pad to terabytes
    ks = np.asarray([128001] + [1] * 4999, np.int64)
    with pytest.raises(ts._BadRequest, match="would pad"):
        svc.do_fit_many(ts._npz_bytes(
            psc=np.zeros((int(ks.sum()), 4)),
            stim=np.zeros((2, int(ks.sum()))), k_trues=ks.astype(np.int32)),
            opts)
    # ... nor a narrow (int8) stim undercut the cap
    ks = np.asarray([128001] + [1] * 1999, np.int64)
    with pytest.raises(ts._BadRequest, match="would pad"):
        svc.do_fit_many(ts._npz_bytes(
            psc=np.zeros((int(ks.sum()), 1), np.float32),
            stim=np.zeros((20, int(ks.sum())), np.int8),
            k_trues=ks.astype(np.int32)), opts)
    pscs = np.stack([sim["psc"][:64]] * 2)
    stims = np.stack([sim["stim_matrix"][:, :64]] * 2)
    with pytest.raises(ts._BadRequest, match="experiments"):
        svc.do_fit_many(ts._npz_bytes(pscs=pscs[:1], stims=stims), opts)
    with pytest.raises(ts._BadRequest, match="unknown fit_many method"):
        svc.do_fit_many(ts._npz_bytes(pscs=pscs, stims=stims),
                        json.dumps({"method": "cosamp"}))


def test_sharded_requests_get_the_unmeshed_400(svc, sim):
    opts = {"iters": 2, "demix": False, "sharded": True}
    with pytest.raises(ts._BadRequest, match="has no mesh"):
        svc.do_fit(_body(sim), json.dumps(opts))
    pscs = np.stack([sim["psc"][:64]] * 2)
    stims = np.stack([sim["stim_matrix"][:, :64]] * 2)
    with pytest.raises(ts._BadRequest, match="has no mesh"):
        svc.do_fit_many(ts._npz_bytes(pscs=pscs, stims=stims),
                        json.dumps(opts))
    with pytest.raises(ts._BadRequest, match="drop 'sharded'"):
        svc.do_fit_many(ts._npz_bytes(
            psc=sim["psc"][:160], stim=sim["stim_matrix"][:, :160],
            k_trues=np.asarray([64, 96], np.int32)),
            json.dumps(dict(opts, method="mbcs")))
    assert json.loads(svc.do_health()[1])["mesh_devices"] == 0


def test_a_mesh_is_not_ported_yet():
    """Since A9 a server takes a mesh: N shards on the named device, or
    the first N GPUs, which without one raises the device rule's
    error."""
    svc = ts.FitService(mesh_devices=2, device="cpu")
    assert json.loads(svc.do_health()[1])["mesh_devices"] == 2
    assert svc.mesh.devices == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts.FitService(mesh_devices=2)


def test_stream_creation_rules(svc, sim):
    body = _body(sim, k=100)
    upd = {"iters": 1, "demix": False}
    # a failed first update does not burn the name
    with pytest.raises(ts._BadRequest, match="stream-create"):
        svc.do_stream_update("once", body, json.dumps(
            dict(upd, create={"bogus": 1})))
    assert "once" not in svc.streams
    with pytest.raises(ts._BadRequest, match="JSON object"):
        svc.do_stream_update("once", body, json.dumps(dict(upd, create=3)))
    svc.do_stream_update("once", body, json.dumps(
        dict(upd, create={"analytic_mc": True})))
    with pytest.raises(ts._BadRequest, match="already exists"):
        svc.do_stream_update("once", body, json.dumps(
            dict(upd, create={"analytic_mc": True})))
    with pytest.raises(ts._BadRequest, match="no stream"):
        svc.do_stream_posterior("never")
    with pytest.raises(ts._BadRequest, match="state-dir"):
        svc.do_stream_save("once")
    with pytest.raises(ts._BadRequest, match="already live"):
        svc.do_stream_load("once", None)
    svc.do_stream_delete("once")
    with pytest.raises(ts._BadRequest, match="no stream"):
        svc.do_stream_delete("once")
    with pytest.raises(ts._BadRequest, match="state-dir"):
        svc.do_stream_load("once", None)


def test_failed_first_design_call_is_retryable(svc):
    spec = {"N": 6, "H": 2, "powers": [55.0]}
    with pytest.raises(ts._BadRequest, match="trials"):
        svc.do_stream_design("d", json.dumps({"designer": spec}))
    assert "d" not in svc.designers  # name not burned
    with pytest.raises(ts._BadRequest, match="first design call"):
        svc.do_stream_design("d", json.dumps({"trials": 8}))
    with pytest.raises(ts._BadRequest, match="designer needs"):
        svc.do_stream_design("d", json.dumps({"designer": {"N": 6}}))
    ctype, payload = svc.do_stream_design(
        "d", json.dumps({"designer": spec, "trials": 8}))
    assert ctype == "application/npz"
    out = ts._load_npz(payload)
    assert out["stim"].shape == (6, 8) and not out["resolved"]
    assert "d" in svc.designers
    with pytest.raises(ts._BadRequest, match="already has a designer"):
        svc.do_stream_design("d", json.dumps({"designer": spec}))


def test_stale_designer_sidecar_removed_on_save(tmp_path):
    svc = ts.FitService(state_dir=str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    psc = np.abs(rng.normal(size=(130, 900))).astype(np.float32)
    stim = np.zeros((6, 130))
    stim[rng.integers(0, 6, 130), np.arange(130)] = 55.0
    body = ts._npz_bytes(psc=psc, stim=stim)
    upd = json.dumps({"iters": 1, "demix": False,
                      "create": {"analytic_mc": True}})
    svc.do_stream_update("s", body, upd)
    svc.do_stream_design("s", json.dumps(
        {"designer": {"N": 6, "H": 2, "powers": [55.0]}, "trials": 8}))
    saved = json.loads(svc.do_stream_save("s")[1])
    assert saved == {"saved": "s", "trial_count": 130, "iterations": 1,
                     "designer": True}
    dpath = svc._designer_path("s")
    assert os.path.exists(dpath)
    svc.do_stream_delete("s")
    svc.do_stream_update("s", body, upd)  # the name again, no designer
    svc.do_stream_save("s")
    assert not os.path.exists(dpath)
    svc.do_stream_delete("s")
    loaded = json.loads(svc.do_stream_load("s", None)[1])
    assert loaded["trial_count"] == 130 and loaded["designer"] is False
    assert "s" not in svc.designers
    with pytest.raises(ts._BadRequest, match="already live"):
        svc.do_stream_load("s", None)
    # names are quoted into single path components
    assert os.path.dirname(svc._stream_path("rig A/slice#2")) == \
        str(tmp_path)


def test_return_fields_trim_the_response(svc, sim):
    body = _body(sim, k=128)
    opts = dict(FIT_OPTS, demix=False)
    full = _load(svc.do_fit(body, json.dumps(opts)))
    trimmed = _load(svc.do_fit(body, json.dumps(
        dict(opts, return_fields=["mu", "beta"]))))
    assert set(trimmed) == {"mu", "beta", "fit_time_s"}
    assert np.array_equal(trimmed["mu"], full["mu"])
    assert np.array_equal(trimmed["beta"], full["beta"])
    assert len(ts._npz_bytes(**trimmed)) < len(ts._npz_bytes(**full)) / 10
    with pytest.raises(ts._BadRequest, match="available"):
        svc.do_fit(body, json.dumps(dict(opts, return_fields=["muu"])))
    with pytest.raises(ts._BadRequest, match="list of field names"):
        svc.do_fit(body, json.dumps(dict(opts, return_fields=7)))
    pscs = np.stack([sim["psc"][:64]] * 2)
    stims = np.stack([sim["stim_matrix"][:, :64]] * 2)
    got = _load(svc.do_fit_many(ts._npz_bytes(pscs=pscs, stims=stims),
                                json.dumps(dict(MANY_OPTS["caviar"],
                                                demix=False,
                                                return_fields=["mu"]))))
    assert set(got) == {"mu"} and got["mu"].shape == (2, N)


def test_response_wires_for_demix_and_fit(port_url, sim):
    cli = ts.FitClient(port_url)
    psc = np.asarray(sim["psc"][:64])
    plain = cli.demix(psc)
    q8 = cli.demix(psc, response_wire="int8")
    q4 = cli.demix(psc, response_wire="int4")
    f16 = cli.demix(psc, response_wire="f16")
    assert f16.dtype == q8.dtype == q4.dtype == np.float32
    assert np.abs(f16 - plain).max() <= 2e-3 * np.abs(plain).max()
    peak = np.abs(plain).max(axis=1, keepdims=True)
    assert np.abs(q8 - plain).max() <= (peak / 127).max() * 0.51
    assert np.abs(q4 - plain).max() <= (peak / 7).max() * 0.51
    stim = np.asarray(sim["stim_matrix"][:, :64])
    full = cli.fit(psc, stim, demix=False, **FIT_OPTS)
    coded = cli.fit(psc, stim, demix=False, response_wire="int8",
                    **FIT_OPTS)
    assert set(coded) == set(full)
    tol = np.maximum(np.abs(full["lam"]).max(axis=1, keepdims=True),
                     1.0) / 127 * 0.51
    assert (np.abs(coded["lam"] - full["lam"]) <= tol).all()
    assert np.array_equal(coded["mu"], full["mu"])
    with pytest.raises(RuntimeError, match="HTTP 400.*response_wire"):
        cli.fit(psc, stim, demix=False, response_wire="int4", iters=2)


def test_ragged_metadata_is_gated_and_restores_true_shapes(svc, port_url,
                                                           sim):
    ks = np.asarray([64, 96], np.int32)
    body = ts._npz_bytes(psc=sim["psc"][:160],
                         stim=sim["stim_matrix"][:, :160], k_trues=ks)
    opts = dict(MANY_OPTS["caviar"], demix=False)
    legacy = _load(svc.do_fit_many(body, json.dumps(opts)))
    assert not any(k.startswith("_") for k in legacy)
    assert all(v.shape[0] == 2 for k, v in legacy.items() if k != "k_trues")
    meta = _load(svc.do_fit_many(body, json.dumps(dict(opts, wire_meta=1))))
    assert {"lam", "z"} <= {str(k) for k in meta["_k_fields"]}
    # mbcs receptive_fields [N, P_b] over different level tables come
    # back at their true shapes through the client
    s0 = sim["stim_matrix"][:, :64]
    s1 = sim["stim_matrix"][:, 64:160].copy()
    s1[s1 == 65.0] = 55.0
    p0, p1 = (len(np.unique(s[s > 0])) for s in (s0, s1))
    assert p0 != p1
    res = ts.FitClient(port_url).fit_many(
        [sim["psc"][:64], sim["psc"][64:160]], [s0, s1], method="mbcs",
        iters=2, num_mc_samples_noise_model=10, demix=False)
    assert res[0]["receptive_fields"].shape[-1] == p0 + 1
    assert res[1]["receptive_fields"].shape[-1] == p1 + 1
    assert [r["lam"].shape for r in res] == [(N, 64), (N, 96)]


def test_client_retries_without_wire_meta_on_an_older_server(sim,
                                                             monkeypatch):
    monkeypatch.setattr(ts, "_FIT_MANY_OPTION_KEYS",
                        frozenset(ts._FIT_MANY_OPTION_KEYS - {"wire_meta"}))
    with loopback(ts.FitService(device="cpu"), ts._make_handler) as url:
        res = ts.FitClient(url).fit_many(
            [sim["psc"][:64], sim["psc"][64:160]],
            [sim["stim_matrix"][:, :64], sim["stim_matrix"][:, 64:160]],
            **MANY_OPTS["caviar"])
    assert [r["lam"].shape for r in res] == [(N, 64), (N, 96)]
    assert not any(k.startswith("_") for r in res for k in r)
    # list inputs of one length still return lists; arrays the stack
    with loopback(ts.FitService(device="cpu"), ts._make_handler) as url:
        cli = ts.FitClient(url)
        pscs = [sim["psc"][:64], sim["psc"][64:128]]
        stims = [sim["stim_matrix"][:, :64], sim["stim_matrix"][:, 64:128]]
        assert isinstance(cli.fit_many(pscs, stims, iters=2), list)
        assert cli.fit_many(np.stack(pscs), np.stack(stims),
                            iters=2)["lam"].shape == (2, N, 64)
        with pytest.raises(ValueError, match="matching list"):
            cli.fit_many([sim["psc"][:64], sim["psc"][:96]],
                         np.stack(stims), iters=2)


def test_decode_fuzz_never_escapes_bad_request():
    from circuitmap_torch.utils.quant import PackedInt4Traces

    rng = np.random.RandomState(7)
    wire_keys = ["stim_sparse_targets", "stim_sparse_codes",
                 "stim_sparse_levels", "stim_sparse_n",
                 "stims_sparse_targets", "stims_sparse_codes",
                 "stims_sparse_levels", "stims_sparse_n", "stims_sparse_b",
                 "psc_q8", "psc_q8_scale", "psc_q4", "psc_q4_scale",
                 "psc_q4_t", "psc_q4_lead", "psc_q4_dec", "psc", "stim"]
    dtypes = [np.int8, np.uint8, np.int16, np.int64, np.float32, np.float64]
    for trial in range(60):
        arrays = {}
        for key in rng.choice(wire_keys, rng.randint(1, 6), replace=False):
            shape = tuple(rng.randint(0, 5)
                          for _ in range(rng.randint(0, 3)))
            arrays[key] = (rng.randint(-9, 9, size=shape)
                           * rng.randn()).astype(
                               dtypes[rng.randint(len(dtypes))])
        try:
            out = ts._decode_arrays(ts._load_npz(ts._npz_bytes(**arrays)))
        except ts._BadRequest:
            continue
        for v in out.values():
            assert isinstance(v, (np.ndarray, PackedInt4Traces)), trial


def test_warm_runs_the_pipeline_at_each_shape(port_url):
    out = ts.FitClient(port_url).warm([[20, 200], [24, 160]], iters=2,
                                      batch=2)
    assert sorted(out["warmed"]) == ["20x200", "24x160", "2x20x200",
                                     "2x24x160"]
    assert all(v >= 0 for v in out["warmed"].values())


def test_closed_loop_design_over_the_wire(port_url):
    from circuitmap_torch import simulate

    cli = ts.FitClient(port_url)
    np.random.seed(9)
    truth = simulate(N=12, trials=240, H=2, connection_prob=0.3,
                     verbose=False, device="cpu")
    first = cli.stream_design("loop", trials=60, designer={
        "N": 12, "H": 2, "powers": [45.0, 55.0, 65.0]})
    assert first["stim"].shape == (12, 60) and int(first["rounds"]) == 0
    reply = cli.stream_update("loop", truth["psc"][:60], first["stim"],
                              iters=3, demix=False)
    assert "designer_error" not in reply
    nxt = cli.stream_design("loop", trials=60)
    assert int(nxt["rounds"]) == 1
    assert cli.health()["streams"]["loop"]["trials"] == 60
    cli.stream_delete("loop")


# ------------------------------------------------------------ the profiler


def test_profile_captures_a_chrome_trace(svc, sim, tmp_path):
    d = str(tmp_path / "trace")
    with pytest.raises(ts._BadRequest, match="no active profile"):
        svc.do_profile(json.dumps({"action": "stop"}))
    with pytest.raises(ts._BadRequest, match="action"):
        svc.do_profile(json.dumps({"action": "pause"}))
    start = json.loads(svc.do_profile(json.dumps(
        {"action": "start", "dir": d}))[1])
    try:
        assert start == {"profiling": True, "dir": d}
        with pytest.raises(ts._BadRequest, match="already active"):
            svc.do_profile(json.dumps({"action": "start"}))
        svc.do_fit(_body(sim), json.dumps({"iters": 2, "demix": False}))
    finally:
        stop = json.loads(svc.do_profile(json.dumps({"action": "stop"}))[1])
    assert stop["profiling"] is False and stop["dir"] == d
    with open(stop["trace"]) as fh:
        events = json.load(fh)["traceEvents"]
    assert events and svc._profile_dir is None


def test_profile_dir_is_confined(monkeypatch, tmp_path):
    import tempfile

    svc = ts.FitService(device="cpu")
    with pytest.raises(ts._BadRequest, match="temp dir"):
        svc.do_profile(json.dumps({"action": "start",
                                   "dir": "/etc/cron.d/x"}))
    escape = os.path.join(tempfile.gettempdir(), "..", "etc", "x")
    with pytest.raises(ts._BadRequest, match="temp dir"):
        svc.do_profile(json.dumps({"action": "start", "dir": escape}))
    svc2 = ts.FitService(state_dir=str(tmp_path / "state"), device="cpu")
    d = str(tmp_path / "state" / "prof")
    out = json.loads(svc2.do_profile(json.dumps(
        {"action": "start", "dir": d}))[1])
    assert out["dir"] == d
    assert svc2.stop_profile() == os.path.join(d, "trace.json")


class _Profiler:
    def __init__(self, start_error=None, stop_error=None):
        self.start_error, self.stop_error = start_error, stop_error

    def start(self):
        if self.start_error:
            raise RuntimeError(self.start_error)

    def stop(self):
        if self.stop_error:
            raise RuntimeError(self.stop_error)

    def export_chrome_trace(self, path):
        pass


def test_profiler_failures_never_wedge_the_service(monkeypatch, tmp_path):
    svc = ts.FitService(device="cpu")
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Profiler(
        start_error="profiler plugin unavailable"))
    with pytest.raises(ts._BadRequest, match="plugin unavailable"):
        svc.do_profile(json.dumps({"action": "start",
                                   "dir": str(tmp_path / "a")}))
    assert svc._profile_dir is None
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Profiler(
        stop_error="finalise failed"))
    svc.do_profile(json.dumps({"action": "start",
                               "dir": str(tmp_path / "b")}))
    with pytest.raises(RuntimeError, match="may be incomplete"):
        svc.do_profile(json.dumps({"action": "stop"}))
    assert svc._profile_dir is None  # a new start works
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Profiler())
    out = json.loads(svc.do_profile(json.dumps(
        {"action": "start", "dir": str(tmp_path / "c")}))[1])
    assert out["profiling"] is True
    svc.stop_profile()


# ----------------------------------------------- the sidecar and the watchdog


class _FakeSvc:
    """Minimal stand-in for FitService in watchdog tests."""

    def __init__(self):
        self.inflight = None
        self.state_dir = None
        self.streams = {}
        self.metrics_fh = None
        self.saved = 0

    def save_all_streams(self):
        self.saved += 1
        return {}


def test_status_sidecar_busy_idle_and_404():
    import urllib.error
    import urllib.request

    svc = ts.FitService(device="cpu")
    httpd = ts.start_status_server(svc, port=0)
    try:
        port = httpd.server_address[1]

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return json.loads(r.read())

        h = get("/health")
        assert h["status"] == "ok" and h["busy"] is False
        assert h["platform"] == "cpu" and "inflight" not in h
        svc.inflight = ("POST", "/fit", time.monotonic() - 3)
        h = get("/status")
        assert h["busy"] is True
        assert (h["inflight"]["method"], h["inflight"]["path"]) == (
            "POST", "/fit")
        assert h["inflight"]["seconds"] >= 3
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/fit")
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_handler_tracks_inflight_auth_and_metrics(tmp_path):
    import urllib.error
    import urllib.request

    svc = ts.FitService(device="cpu")
    seen = []
    orig = svc.do_health

    def spy():
        seen.append(svc.inflight)
        return orig()

    svc.do_health = spy
    svc.auth_token = "s3cret"
    svc.metrics_fh = open(tmp_path / "metrics.jsonl", "a")
    try:
        with loopback(svc, ts._make_handler) as url:
            with pytest.raises(RuntimeError, match="HTTP 401"):
                ts.FitClient(url).health()
            assert ts.FitClient(url, token="s3cret").health()["status"] == \
                "ok"
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(
                    url + "/nowhere", headers={
                        "Authorization": "Bearer s3cret"}), timeout=10)
            assert ei.value.code == 404
    finally:
        svc.metrics_fh.close()
    assert len(seen) == 1 and seen[0][:2] == ("GET", "/health")
    assert svc.inflight is None
    lines = [json.loads(x) for x in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["status"] for x in lines] == [401, 200, 404]


def test_watchdog_fires_only_past_timeout():
    svc = _FakeSvc()
    fired = []
    stop = ts.start_watchdog(svc, 0.5, exit_fn=fired.append)
    try:
        time.sleep(0.8)
        assert fired == []
        svc.inflight = ("POST", "/fit", time.monotonic())
        assert fired == []
        deadline = time.time() + 15
        while not fired and time.time() < deadline:
            time.sleep(0.05)
        assert fired == [ts.WATCHDOG_EXIT_CODE] == [86]
    finally:
        stop.set()


def test_watchdog_cancel_and_stream_save():
    svc = _FakeSvc()
    fired = []
    stop = ts.start_watchdog(svc, 0.1, exit_fn=fired.append)
    stop.set()
    svc.inflight = ("POST", "/fit", time.monotonic() - 60)
    time.sleep(0.5)
    assert fired == []
    svc = _FakeSvc()
    svc.state_dir, svc.streams = "/nonexistent", {"live": object()}
    stop = ts.start_watchdog(svc, 0.1, exit_fn=fired.append, grace_s=10)
    try:
        svc.inflight = ("POST", "/stream/live/update", time.monotonic() - 60)
        deadline = time.time() + 10
        while not fired and time.time() < deadline:
            time.sleep(0.05)
        assert fired == [ts.WATCHDOG_EXIT_CODE] and svc.saved == 1
    finally:
        stop.set()


# ------------------------------------------------------- client retries


class _FakeResp:
    headers = {"Content-Type": "application/json"}

    def read(self):
        return b'{"ok": true}'

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_client_retries_stateless_endpoints_only(monkeypatch):
    import urllib.error
    import urllib.request

    calls = []

    def fake_urlopen(req, timeout=None):
        calls.append(req.selector)
        if len(calls) < 3:
            raise urllib.error.URLError(ConnectionRefusedError(111, "no"))
        return _FakeResp()

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    cli = ts.FitClient("http://127.0.0.1:1", retries=2, retry_backoff_s=0.01)
    assert cli.health() == {"ok": True} and len(calls) == 3
    calls.clear()
    with pytest.raises(OSError):
        cli.stream_save("exp")
    assert len(calls) == 1
    calls.clear()
    with pytest.raises(OSError):
        ts.FitClient("http://127.0.0.1:1").health()
    assert len(calls) == 1


def test_client_never_retries_timeouts_or_http_errors(monkeypatch):
    import io
    import socket
    import urllib.error
    import urllib.request

    calls = []

    def raw_timeout(req, timeout=None):
        calls.append(1)
        raise socket.timeout("timed out")

    def wrapped_timeout(req, timeout=None):
        calls.append(1)
        raise urllib.error.URLError(socket.timeout("timed out"))

    def http_error(req, timeout=None):
        calls.append(1)
        raise urllib.error.HTTPError(req.full_url, 400, "Bad Request", {},
                                     io.BytesIO(b'{"error": "bad"}'))

    cli = ts.FitClient("http://127.0.0.1:1", retries=5, retry_backoff_s=0.01)
    for fake, err in ((raw_timeout, OSError), (wrapped_timeout, OSError),
                      (http_error, RuntimeError)):
        calls.clear()
        monkeypatch.setattr(urllib.request, "urlopen", fake)
        with pytest.raises(err):
            cli.health()
        assert len(calls) == 1


def test_wait_ready_rides_out_a_restart_and_times_out():
    svc = ts.FitService(device="cpu")
    box = [None]
    httpd = HTTPServer(("127.0.0.1", 0), ts._make_handler(svc, box))
    box[0] = httpd
    cli = ts.FitClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    threading.Timer(0.3, lambda: threading.Thread(
        target=httpd.serve_forever, daemon=True).start()).start()
    try:
        assert cli.wait_ready(timeout_s=30, poll_s=0.1)["status"] == "ok"
    finally:
        httpd.shutdown()
        httpd.server_close()
    with pytest.raises(TimeoutError, match="not ready"):
        ts.FitClient("http://127.0.0.1:1", timeout=1).wait_ready(
            timeout_s=0.3, poll_s=0.05)
