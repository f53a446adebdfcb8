"""The readers of the program's spans and request-log stages, on hand-made
slices: a ``Trace`` of host spans and device operations (microseconds)
and request-log rows, with each reader's None where the program gives it
nothing to read (a program without the spans, as before they existed)."""

import pytest

from cmbench import harness
from cmbench.trace import Trace


def ctx(host=(), ops=(), log=None, start=0.0, end=1000.0):
    return harness.Context(trace=Trace(list(ops), list(host), start, end),
                           request_log=log)


# two fits: [0, 300] and [400, 600]
FITS = [("cm.fit", 0.0, 300.0), ("cm.fit.stim", 10.0, 30.0),
        ("cm.fit", 400.0, 600.0), ("cm.fit.stim", 410.0, 450.0)]
OPS = [("sweep_cluster_kernel", 50.0, 150.0),
       ("Memcpy DtoH (Device -> Pageable)", 100.0, 120.0),  # overlaps
       ("Memcpy DtoH (Device -> Pageable)", 280.0, 320.0),  # runs past
       ("Memcpy DtoH (Device -> Pageable)", 350.0, 360.0),  # between fits
       ("Memcpy HtoD (Pageable -> Device)", 420.0, 430.0),
       ("Memcpy DtoH (Device -> Pinned)", 500.0, 540.0)]


# the same fits with the stim stage split in two spans, as CAVIaR opens
# them: the sparsify before the traces' stage, the upload after it
FITS_SPLIT = [("cm.fit", 0.0, 300.0), ("cm.fit.stim", 10.0, 15.0),
              ("cm.fit.traces", 15.0, 20.0), ("cm.fit.stim", 20.0, 35.0),
              ("cm.fit", 400.0, 600.0), ("cm.fit.stim", 410.0, 420.0),
              ("cm.fit.stim", 425.0, 455.0)]


@pytest.mark.parametrize("host", [FITS, FITS_SPLIT], ids=["one", "split"])
def test_fit_stim_ms_sums_the_stim_spans_of_each_fit(host):
    assert harness.reader("fit.stim_ms")(ctx(host, OPS)) == \
        pytest.approx((20.0 + 40.0) / 2 / 1e3)


def test_fit_idle_ms_is_each_fits_span_less_its_busy_time():
    # fit 1: busy [50, 150] and [280, 300] of 300 us; fit 2: [420, 430]
    # and [500, 540] of 200 us
    want = ((300 - 120) + (200 - 50)) / 2 / 1e3
    assert harness.reader("fit.idle_ms")(ctx(FITS, OPS)) == \
        pytest.approx(want)


def test_fit_host_reads_counts_the_copies_to_the_host_a_fit_starts():
    # fit 1: the copies at 100 and 280; fit 2: the one at 500
    assert harness.reader("fit.host_reads")(ctx(FITS, OPS)) == 1.5


def test_demix_encode_ms_sums_the_chunks_encodes_of_each_call():
    host = [("cm.demix", 0.0, 100.0), ("cm.wire.encode", 5.0, 10.0),
            ("cm.demix.net", 10.0, 40.0), ("cm.wire.encode", 40.0, 47.0),
            ("cm.demix", 200.0, 300.0), ("cm.wire.encode", 205.0, 209.0),
            # the fit's raw-trace wire, outside any demix call
            ("cm.wire.encode", 400.0, 450.0)]
    assert harness.reader("demix.encode_ms")(ctx(host, OPS)) == \
        pytest.approx((12.0 + 4.0) / 2 / 1e3)


@pytest.mark.parametrize("name", ["client.encode_ms", "client.decode_ms"])
def test_client_metrics_are_the_mean_client_span(name):
    span = "cm." + name[:-3]
    host = [(span, 0.0, 30.0), ("aten::add", 1.0, 2.0), (span, 50.0, 60.0)]
    assert harness.reader(name)(ctx(host)) == pytest.approx(0.02)


ROWS = [{"path": "/fit", "status": 200, "seconds": 1.0,
         "stages": {"read": 0.01, "decode": 0.02, "demix": 0.3, "fit": 0.4,
                    "encode": 0.05, "write": 0.1}},
        {"path": "/fit", "status": 200, "seconds": 1.0,
         "stages": {"read": 0.01, "decode": 0.04, "demix": 0.3, "fit": 0.4,
                    "encode": 0.07, "write": 0.2}},
        {"path": "/fit", "status": 400, "seconds": 0.1,
         "stages": {"read": 0.01, "decode": 0.09}}]


@pytest.mark.parametrize("name,want", [("serve.decode_ms", 30.0),
                                       ("serve.encode_ms", 60.0),
                                       ("serve.write_ms", 150.0)])
def test_serve_stage_metrics_are_the_mean_over_answered_rows(name, want):
    assert harness.reader(name)(ctx(log=ROWS)) == pytest.approx(want)


NEW = ["fit.stim_ms", "fit.idle_ms", "fit.host_reads", "demix.encode_ms",
       "client.encode_ms", "client.decode_ms", "serve.decode_ms",
       "serve.encode_ms", "serve.write_ms"]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_gives_none(name):
    # the host events of a program that opens no span, and its log rows
    # without stages
    host = [("aten::mm", 0.0, 10.0), ("window_slice", 0.0, 1000.0)]
    rows = [{k: v for k, v in r.items() if k != "stages"} for r in ROWS]
    assert harness.reader(name)(ctx(host, OPS, log=rows)) is None


@pytest.mark.parametrize("name", NEW)
def test_an_empty_slice_gives_none(name):
    assert harness.reader(name)(ctx(log=None)) is None
