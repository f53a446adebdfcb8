"""The fit server's wire in circuitmap_torch against the JAX package.

The port keeps its own copies of the JAX package's numpy codecs (the
sparse stim hologram, the int8/int4/int4d2 trace bodies, the decode of
every body form, ``PackedInt4Traces``), so the two packages' servers and
clients interoperate: each codec must give the JAX package's bytes on
the same inputs. Then the packed int4 body must reach the device as its
codes (``prepare_traces``, the demixer, the ``*_many`` upload) with the
result of its dense decode, and ``Model.fit(_materialize=)``,
``utils/synthetic.py`` and ``utils/io.py`` must match their JAX
counterparts. All on the CPU, at small shapes.
"""

import json

import numpy as np
import pytest
import torch

from circuitmap_torch import serve as ts
from circuitmap_tpu import serve as js

CHECKPOINT = "demixers/nwd_ie_ChroME2f_int4d2qat.npz"


def _traces(seed, shape, scale=5.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.random(shape[:-1] + (1,)) * scale
    return x


def _stim(seed, n=30, k=300, h=4, powers=(45.0, 55.0, 65.0)):
    rng = np.random.default_rng(seed)
    stim = np.zeros((n, k))
    for j in range(k):
        stim[rng.choice(n, h, replace=False), j] = rng.choice(powers)
    return stim


def _same_dict(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert np.array_equal(x, y), key


# ----------------------------------------------------------- the codecs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sparse_stim_encoding_matches_jax_byte_for_byte(dtype):
    stim = _stim(0).astype(dtype)
    ours, theirs = ts.encode_stim_sparse(stim), js.encode_stim_sparse(stim)
    _same_dict(ours, theirs)
    assert ts._npz_bytes(**ours) == js._npz_bytes(**theirs)
    dec = ts._decode_arrays(ts._load_npz(ts._npz_bytes(**ours)))["stim"]
    assert dec.dtype == stim.dtype and np.array_equal(dec, stim)
    # a dense matrix is not worth encoding, in either package
    dense = np.random.default_rng(1).standard_normal((40, 40))
    assert ts.encode_stim_sparse(dense) is None
    assert js.encode_stim_sparse(dense) is None


def test_sparse_stims_of_a_batch_decode_like_jax():
    stims = np.stack([_stim(s, k=120) for s in range(3)])
    flat = stims.transpose(1, 0, 2).reshape(stims.shape[1], -1)
    enc = {k.replace("stim_", "stims_", 1): v
           for k, v in ts.encode_stim_sparse(flat).items()}
    enc["stims_sparse_b"] = np.int32(3)
    body = ts._npz_bytes(**enc)
    ours = ts._decode_arrays(ts._load_npz(body))
    theirs = js._decode_arrays(js._load_npz(body))
    _same_dict(ours, theirs)
    assert np.array_equal(ours["stims"], stims)


@pytest.mark.parametrize("shape", [(16, 300), (2, 6, 301)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_int8_trace_encoding_matches_jax_byte_for_byte(shape, dtype):
    psc = _traces(2, shape).astype(dtype)
    psc.reshape(-1, shape[-1])[3] = 0.0  # an all-zero trace survives
    ours, theirs = ts.encode_psc_int8(psc), js.encode_psc_int8(psc)
    _same_dict(ours, theirs)
    assert ts._npz_bytes(**ours) == js._npz_bytes(**theirs)


@pytest.mark.parametrize("wire", ["int4", "int4d2", "int8", "f16", "f32",
                                  None])
@pytest.mark.parametrize("t_len", [300, 301])
def test_trace_body_encoding_matches_jax_byte_for_byte(wire, t_len):
    psc = _traces(3, (12, t_len))
    ours, theirs = ts._encode_psc(psc, wire), js._encode_psc(psc, wire)
    _same_dict(ours, theirs)
    assert ts._npz_bytes(**ours) == js._npz_bytes(**theirs)


def test_unknown_trace_wire_is_rejected_like_jax():
    with pytest.raises(ValueError, match="unknown psc_wire") as ours:
        ts._encode_psc(np.zeros((2, 4)), "int2")
    with pytest.raises(ValueError) as theirs:
        js._encode_psc(np.zeros((2, 4)), "int2")
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------- the clients' requests


def _client_calls():
    psc, stim = _traces(9, (40, 64)), _stim(10, n=12, k=40, h=2)
    pscs = np.stack([psc[:20], psc[20:]])
    stims = np.stack([stim[:, :20], stim[:, 20:]])
    return {
        "fit_dense": lambda c: c.fit(psc, stim, sparse_stim=False, iters=3,
                                     seed=1),
        "fit_sparse": lambda c: c.fit(psc, stim, demix=False,
                                      return_fields="mu", iters=3),
        "fit_dense_int4d2": lambda c: c.fit(
            psc, stim, sparse_stim=False, psc_wire="int4d2",
            trace_wire="int4d2", response_wire="int8"),
        "fit_sparse_int4d2": lambda c: c.fit(
            psc, stim, method="mbcs", psc_wire="int4d2",
            return_fields=["mu", "lam"]),
        "fit_many_stacked": lambda c: c.fit_many(
            pscs, stims, demix=True, return_fields=("mu",),
            method="cavi_sns", seeds=[1, 2]),
        "fit_many_stacked_dense": lambda c: c.fit_many(
            pscs, stims, sparse_stim=False, psc_wire="int4", iters=2),
        "fit_many_ragged": lambda c: c.fit_many(
            [psc[:16], psc[16:]], [stim[:, :16], stim[:, 16:]],
            psc_wire="int8", return_fields="mu", iters=2),
        "demix": lambda c: c.demix(psc, trace_wire="int8", psc_wire="f16",
                                   response_wire="int4"),
        "stream_update": lambda c: c.stream_update(
            "rig A/1", psc, stim, iters=4, create={"seed": 2}, demix=False),
    }


CLIENT_CALLS = _client_calls()


def _canned_reply(path):
    """A response each client method can unpack: JSON for a stream,
    else a two-experiment npz."""
    if path.startswith("/stream/"):
        return b"{}", "application/json"
    key = "demixed" if path == "/demix" else "mu"
    return (ts._npz_bytes(**{key: np.zeros((2, 3), np.float32)}),
            "application/npz")


class _FrozenZipClock:
    """``np.savez`` stamps each zip member with the local time to 2 s;
    held still, two bodies built a moment apart differ only where their
    contents do."""

    @staticmethod
    def time():
        return 0.0

    @staticmethod
    def localtime(*_):
        return (2020, 1, 1, 0, 0, 0)


@pytest.mark.parametrize("call", sorted(CLIENT_CALLS))
def test_the_clients_send_jaxs_requests_byte_for_byte(call, monkeypatch):
    """Each FitClient method sends the JAX package's client's method,
    path, X-Options header and npz body, byte for byte."""
    import zipfile

    monkeypatch.setattr(zipfile, "time", _FrozenZipClock)
    sent = {"ours": [], "theirs": []}

    def record(who, method, path, body, options):
        sent[who].append((method, path,
                          json.dumps(options) if options else None, body))
        return _canned_reply(path)

    monkeypatch.setattr(
        ts.FitClient, "_exchange",
        lambda self, method, path, body=None, options=None: record(
            "ours", method, path, body, options))
    monkeypatch.setattr(
        js.FitClient, "_request",
        lambda self, method, path, body=None, options=None: ts.FitClient.
        _decode(*record("theirs", method, path, body, options)))
    CLIENT_CALLS[call](ts.FitClient("http://127.0.0.1:1"))
    CLIENT_CALLS[call](js.FitClient("http://127.0.0.1:1"))
    assert len(sent["ours"]) == 1
    assert sent["ours"] == sent["theirs"]


def _body_forms():
    psc = _traces(4, (10, 301)).astype(np.float32)
    p3 = _traces(5, (2, 6, 64)).astype(np.float32)
    stim = _stim(6, n=8, k=10, h=2)
    forms = {"dense": {"psc": psc, "stim": stim},
             "sparse_stim": {"psc": psc, **ts.encode_stim_sparse(
                 _stim(7, n=8, k=10, h=1))}}
    for wire in ("int8", "int4", "int4d2", "f16"):
        forms[wire] = {**ts._encode_psc(psc, wire), "stim": stim}
        forms["stacked_" + wire] = {"pscs" + k[len("psc"):]: v
                                    for k, v in ts._encode_psc(
                                        p3, wire).items()}
    return forms


BODY_FORMS = _body_forms()


@pytest.mark.parametrize("form", sorted(BODY_FORMS))
def test_decode_of_each_body_form_matches_jax(form):
    body = ts._npz_bytes(**BODY_FORMS[form])
    ours = ts._decode_arrays(ts._load_npz(body))
    theirs = js._decode_arrays(js._load_npz(body))
    assert sorted(ours) == sorted(theirs)
    from circuitmap_torch.utils.quant import PackedInt4Traces
    from circuitmap_tpu.utils.quant import PackedInt4Traces as JaxPacked

    for key in ours:
        a, b = ours[key], theirs[key]
        assert isinstance(a, PackedInt4Traces) == isinstance(b, JaxPacked)
        if isinstance(a, PackedInt4Traces):
            assert (a.shape, a.ndim, len(a), a.decimate, a.lead) == (
                b.shape, b.ndim, len(b), b.decimate, b.lead)
            assert np.array_equal(a.packed, b.packed)
            assert np.array_equal(a.scale, b.scale)
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), key


def _malformed_bodies():
    stim = np.zeros((6, 20))
    stim[2, ::2] = 55.0
    enc = ts.encode_stim_sparse(stim)
    enc8 = ts.encode_psc_int8(np.ones((3, 8), np.float32))
    enc4 = ts._encode_psc(_traces(8, (10, 301)), "int4d2")
    out = {"both_dense_and_sparse": dict(stim=stim, **enc),
           "sparse_missing_key": {k: v for k, v in enc.items()
                                  if k != "stim_sparse_levels"},
           "sparse_target_out_of_range": dict(enc, stim_sparse_n=np.int32(2)),
           "sparse_code_out_of_range": dict(
               enc, stim_sparse_codes=enc["stim_sparse_codes"] + 7),
           "sparse_negative_code": dict(
               enc, stim_sparse_codes=enc["stim_sparse_codes"].astype(
                   np.int16) - 1),
           "sparse_huge_n": dict(enc, stim_sparse_n=np.int64(2 ** 31)),
           "sparse_nonfinite_levels": dict(
               enc, stim_sparse_levels=np.array([np.nan])),
           "int8_nan_scale": dict(enc8, psc_q8_scale=np.full(3, np.nan,
                                                              np.float32)),
           "int8_negative_scale": dict(enc8, psc_q8_scale=np.full(
               3, -1.0, np.float32)),
           "int8_without_scale": {"psc_q8": enc8["psc_q8"]},
           "int4_bad_lead": dict(enc4, psc_q4_lead=np.asarray([5],
                                                               np.int64)),
           "int4_bad_dec": dict(enc4, psc_q4_dec=np.int64(3)),
           "int4_bad_t": dict(enc4, psc_q4_t=np.int64(9000)),
           "int4_missing_key": {k: v for k, v in enc4.items()
                                if k != "psc_q4_t"},
           "int4_and_dense": dict(enc4, psc=np.zeros((10, 301)))}
    return out


MALFORMED = _malformed_bodies()


@pytest.mark.parametrize("form", sorted(MALFORMED))
def test_malformed_bodies_are_client_errors_with_jaxs_message(form):
    body = ts._npz_bytes(**MALFORMED[form])
    with pytest.raises(ts._BadRequest) as ours:
        ts._decode_arrays(ts._load_npz(body))
    with pytest.raises(js._BadRequest) as theirs:
        js._decode_arrays(js._load_npz(body))
    assert str(ours.value) == str(theirs.value)


def test_unreadable_body_and_field_filters_match_jax():
    for mod in (ts, js):
        with pytest.raises(mod._BadRequest, match="readable .npz"):
            mod._load_npz(b"not an npz")
    out = {"mu": np.ones(3), "lam": np.ones((3, 4)),
           "fit_time_s": np.float64(1.0)}
    for fields in (None, "mu", ["mu", "lam"]):
        _same_dict(ts._filter_fields(out, fields),
                   js._filter_fields(out, fields))
        assert ts._normalize_return_fields(fields) == \
            js._normalize_return_fields(fields)
    for bad in (["typo"], [1], 3):
        with pytest.raises(ts._BadRequest) as ours:
            ts._normalize_return_fields(bad)
            ts._filter_fields(out, bad)
        with pytest.raises(js._BadRequest) as theirs:
            js._normalize_return_fields(bad)
            js._filter_fields(out, bad)
        assert str(ours.value) == str(theirs.value)
    for arr in (np.array([[1.0, np.nan]]), np.array(["a", "b"])):
        with pytest.raises(ts._BadRequest) as ours:
            ts._require_finite("psc", arr)
        with pytest.raises(js._BadRequest) as theirs:
            js._require_finite("psc", arr)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------- PackedInt4Traces


@pytest.mark.parametrize("decimate", [1, 2])
@pytest.mark.parametrize("t_len", [300, 301])
def test_packed_traces_match_jax(decimate, t_len):
    from circuitmap_torch.utils import quant as tq
    from circuitmap_tpu.utils import quant as jq

    x = _traces(9, (12, t_len)).astype(np.float32)
    packed, scale = tq.encode_int4_traces(x, decimate=decimate)
    jp, jsc = jq.encode_int4_traces(x, decimate=decimate)
    assert np.array_equal(packed, jp) and np.array_equal(scale, jsc)
    assert np.array_equal(
        tq.decode_int4_traces(packed, scale, t_len, decimate),
        jq.decode_int4_traces(packed, scale, t_len, decimate))
    ours = tq.PackedInt4Traces(packed, scale, t_len, decimate,
                               lead=(3, 4))
    theirs = jq.PackedInt4Traces(packed, scale, t_len, decimate,
                                 lead=(3, 4))
    assert (ours.shape, ours.ndim, len(ours)) == (
        theirs.shape, theirs.ndim, len(theirs)) == ((3, 4, t_len), 3, 3)
    assert np.array_equal(ours.dense(), theirs.dense())
    assert np.array_equal(np.asarray(ours), np.asarray(theirs))
    assert np.asarray(ours, np.float64).dtype == np.float64
    flat = ours.flat()
    assert flat.shape == theirs.flat().shape == (12, t_len)
    assert flat._dense is ours._dense  # the memo is shared
    assert np.array_equal(flat.dense(), theirs.flat().dense())
    assert np.array_equal(flat.rows(2, 5).dense(), flat.dense()[2:5])
    with pytest.raises(ValueError, match="lead"):
        tq.PackedInt4Traces(packed, scale, t_len, decimate, lead=(5,))
    with pytest.raises(ValueError, match="packed must be"):
        tq.PackedInt4Traces(packed, scale, t_len + 7, decimate)


# ------------------------------------- the packed body reaches the device


def _packed(x, decimate):
    from circuitmap_torch.utils.quant import (PackedInt4Traces,
                                              encode_int4_traces)

    flat = x.reshape(-1, x.shape[-1])
    packed, scale = encode_int4_traces(flat, decimate=decimate)
    return PackedInt4Traces(packed, scale, x.shape[-1], decimate,
                            lead=x.shape[:-1])


@pytest.mark.parametrize("decimate", [1, 2])
def test_prepare_traces_takes_packed_codes_as_their_dense_decode(decimate):
    from circuitmap_torch.solvers._common import prepare_traces

    x = _traces(10, (2, 20, 301))
    body = _packed(x, decimate)
    for wire in (None, "int8", "int4", "int4d2"):
        got = prepare_traces(body, torch.float32, torch.device("cpu"),
                             trace_wire=wire)
        assert got.shape == (2, 20, 301)
        if wire == "int4d2" and decimate == 1:
            # codes that were not pooled are pooled and encoded again
            want = prepare_traces(body.flat().dense(), torch.float32,
                                  torch.device("cpu"), trace_wire="int4d2")
            assert torch.equal(got.reshape(40, 301), want)
        else:
            assert np.array_equal(got.numpy(), body.dense())
    # the same codes as the in-process wire makes of the raw traces
    got = prepare_traces(body.flat(), torch.float32, torch.device("cpu"))
    wire = "int4d2" if decimate == 2 else "int4"
    want = prepare_traces(x.reshape(40, 301), torch.float32,
                          torch.device("cpu"), trace_wire=wire)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float64"):
        prepare_traces(body, torch.float64, torch.device("cpu"))


def test_demixer_takes_packed_codes_as_the_in_process_wire():
    from circuitmap_torch.demix.demixer import NeuralDemixer

    dm = NeuralDemixer(CHECKPOINT, device="cpu")
    raw = _traces(11, (40, 900), scale=2.0)
    body = _packed(raw, 2)
    got = dm(body, verbose=False, transfer_dtype="int4d2", chunk_size=16)
    want = dm(raw, verbose=False, transfer_dtype="int4d2", chunk_size=16)
    assert np.array_equal(got, want)
    # with any other wire the codes still go up as they are
    assert np.array_equal(dm(body, verbose=False, chunk_size=16), got)
    assert np.array_equal(
        dm(body.dense(), verbose=False, chunk_size=16), got)


def test_many_uploads_take_packed_stacks_as_their_dense_decode():
    from circuitmap_torch import caviar_many, default_priors

    x = _traces(12, (2, 150, 900), scale=1.0)
    body = _packed(x, 1)
    stims = np.stack([_stim(13 + b, k=150) for b in range(2)])
    p = default_priors(30)
    args = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
            p["phi_cov"])
    kw = dict(iters=3, num_mc_samples=10, verbose=False, device="cpu")
    got = caviar_many(body, stims, *args, **kw)
    want = caviar_many(body.dense(), stims, *args, **kw)
    for g, w in zip(got, want):
        for key in w:
            assert np.array_equal(g[key], w[key]), key
    with pytest.raises(ValueError, match="wire bodies must share"):
        caviar_many([body.flat().rows(0, 100), body.flat().rows(0, 120)],
                    [stims[0][:, :100], stims[1][:, :120]], *args, **kw)


# --------------------------------------------------- Model.fit(_materialize)


def test_materialize_pulls_only_the_requested_fields():
    import circuitmap_torch as cm
    from circuitmap_torch.model import DeviceField

    np.random.seed(5)
    sim = cm.simulate(N=20, trials=200, H=3, connection_prob=0.2,
                      verbose=False, device="cpu")
    opts = {"iters": 3, "num_mc_samples": 10, "verbose": False,
            "save_histories": True}
    full = cm.Model(20).fit(sim["psc"], sim["stim_matrix"],
                            fit_options=dict(opts), device="cpu")
    part = cm.Model(20).fit(sim["psc"], sim["stim_matrix"],
                            fit_options=dict(opts), device="cpu",
                            _materialize=("mu", "history_mu"))
    assert isinstance(part.state["mu"], np.ndarray)
    assert isinstance(part.history["mu"], np.ndarray)
    for key in ("beta", "lam", "phi", "phi_cov", "z", "shape", "rate"):
        v = part.state[key]
        assert isinstance(v, torch.Tensor) and isinstance(v, DeviceField)
        assert np.array_equal(np.asarray(v), full.state[key]), key
    assert np.array_equal(part.state["mu"], full.state["mu"])
    assert part.trial_count == full.trial_count == 200
    assert part._materialize is None  # the policy does not outlive the fit
    for key in full.state:
        assert np.array_equal(np.asarray(part.state[key]),
                              np.asarray(full.state[key])), key


# --------------------------------------------------- synthetic data and IO


def test_synthetic_experiment_and_shapes_match_jax():
    import argparse

    from circuitmap_torch.utils import synthetic as tsyn
    from circuitmap_tpu.utils import synthetic as jsyn

    for args in ((30, 200), (50, 120, 64, 3, (20.0,), 4)):
        for a, b in zip(tsyn.synthetic_experiment(*args),
                        jsyn.synthetic_experiment(*args)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tsyn.parse_shape("1000x20000") == jsyn.parse_shape("1000X20000")
    with pytest.raises(argparse.ArgumentTypeError):
        tsyn.parse_shape("1000-20000")


@pytest.mark.parametrize("fmt", ["npz", "mat", "npy", "h5"])
def test_load_experiment_matches_jax(fmt, tmp_path):
    from circuitmap_torch.utils import io as tio
    from circuitmap_tpu.utils import io as jio

    psc = _traces(14, (50, 90))
    stim = _stim(15, n=12, k=50, h=2)
    path = tmp_path / f"expt.{fmt}"
    if fmt == "npz":
        np.savez(path, psc=psc, stimulus_matrix=stim)
    elif fmt == "npy":
        np.save(path, {"psc": psc, "stimulus_matrix": stim})
    elif fmt == "mat":
        from scipy.io import savemat

        savemat(str(path), {"psc": psc.T, "stimulus_matrix": stim.T})
    else:
        h5py = pytest.importorskip("h5py")
        with h5py.File(path, "w") as f:
            f["psc"], f["stimulus_matrix"] = psc.T, stim.T
    for a, b in zip(tio.load_experiment(path), jio.load_experiment(path)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_experiment_repairs_and_refusals_match_jax(tmp_path):
    from circuitmap_torch.utils import io as tio
    from circuitmap_tpu.utils import io as jio

    psc = _traces(16, (60, 90))
    psc[3, 5] = np.nan
    stim = _stim(17, n=12, k=60, h=2)
    path = tmp_path / "bad.npz"
    np.savez(path, psc=psc, stimulus_matrix=stim)
    for mode in ("drop", "zero"):
        with pytest.warns(UserWarning):
            ours = tio.load_experiment(path, on_nonfinite=mode)
        with pytest.warns(UserWarning):
            theirs = jio.load_experiment(path, on_nonfinite=mode)
        for a, b in zip(ours, theirs):
            assert np.array_equal(a, b)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="non-finite"):
            mod.load_experiment(path)
    short = tmp_path / "short.npz"
    np.savez(short, psc=_traces(18, (58, 90)), stimulus_matrix=stim)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match="trim_trailing"):
            mod.load_experiment(short)
    with pytest.warns(UserWarning):
        ours = tio.load_experiment(short, trim_trailing=True)
    with pytest.warns(UserWarning):
        theirs = jio.load_experiment(short, trim_trailing=True)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_export_state_and_continuous_windows_match_jax(tmp_path):
    from scipy.io import loadmat

    from circuitmap_torch.model import DeviceField
    from circuitmap_torch.utils import io as tio
    from circuitmap_tpu.utils import io as jio
    from circuitmap_tpu.utils import native

    state = {"mu": np.arange(4.0), "beta": np.ones(4),
             "lam": torch.rand(4, 6).as_subclass(DeviceField)}
    ours = tio.export_state(tmp_path / "a", "expt", state)
    theirs = jio.export_state(tmp_path / "b", "expt",
                              {k: np.asarray(v) for k, v in state.items()})
    assert [p.split("/")[-1] for p in ours] == \
        [p.split("/")[-1] for p in theirs]
    a, b = np.load(ours[1]), np.load(theirs[1])
    _same_dict(dict(a), dict(b))
    ma, mb = loadmat(ours[0]), loadmat(theirs[0])
    for key in ("weights", "weight_uncertainty", "spikes"):
        assert np.array_equal(ma[key], mb[key])

    timeline = _traces(19, (5000,)).astype(np.float32)
    raw = tmp_path / "rec.bin"
    timeline.tofile(raw)
    rec = tio.load_continuous_recording(raw)
    assert np.array_equal(rec, jio.load_continuous_recording(raw))
    times = np.array([0, 50, 2000, 4950])
    win = tio.window_continuous_recording(rec, times, pre=100, width=200)
    assert np.array_equal(win, native._extract_windows_np(
        np.asarray(rec, np.float32), times, 100, 200))
    np.testing.assert_allclose(
        win, jio.window_continuous_recording(rec, times, 100, 200),
        rtol=0, atol=0)
    w2, charge = tio.window_continuous_recording(rec, times, pre=100,
                                                 width=200,
                                                 with_charge=True)
    _, jcharge = jio.window_continuous_recording(rec, times, 100, 200,
                                                 with_charge=True)
    assert np.array_equal(w2, win)
    # both packages integrate the charge in the same C++ pass
    assert np.array_equal(charge, jcharge)
