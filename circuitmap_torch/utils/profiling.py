"""Profiling and structured timing (port of
``circuitmap_tpu/utils/profiling.py``): the port's one tracing facility.

  * ``span`` — a named host span on the profiler's clock. The program
    opens one around each stage of a fit, a demix, a served request and
    a client call (the ``cm.*`` names, listed in PERF.md §3); with a
    ``Metrics`` it also records the stage's host seconds;
  * ``Metrics`` — named host-clock spans and scalar metrics collected
    into a list of records (JSON-lines friendly);
  * ``trace`` — a ``torch.profiler`` capture of the enclosed block
    (CPU and, where there is a card, CUDA activity), written as a Chrome
    trace into ``log_dir``;
  * ``annotate`` — ``span`` without a ``Metrics``, the JAX module's name.

A span never synchronises and never reads the device: it marks when the
host entered and left a stage. Device work the stage enqueued may run
after the span closes, and a stage that waits on the device (a pull to
the host) holds the wait inside its span.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path


@contextlib.contextmanager
def span(name, metrics=None, **extra):
    """A named host span: a range in any running ``torch.profiler``
    capture and, with ``metrics``, a ``Metrics`` record of the span's
    host seconds (``time.perf_counter``) with ``extra``'s keys. The
    record is kept when the block raises.

    The range is a ``torch._C._profiler._RecordFunctionFast``: a host
    ``cpu_op`` event, which the profiler does not mirror onto the device
    timeline (a ``record_function`` makes a ``user_annotation`` that it
    does mirror once the range encloses a kernel launch). Without torch
    imported no profiler can be running, and no range is opened (the
    fit client runs on numpy alone)."""
    torch = sys.modules.get("torch")
    rf = None if torch is None else torch._C._profiler._RecordFunctionFast(
        name)
    if rf is not None:
        rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        if metrics is not None:
            metrics.records.append(
                {"name": name, "seconds": seconds, **extra})


class Metrics:
    """Accumulates named timing spans + scalar metrics; dumps JSON lines."""

    def __init__(self):
        self.records = []

    def span(self, name, **extra):
        return span(name, self, **extra)

    def log(self, name, **values):
        self.records.append({"name": name, **values})

    def dump(self, path=None):
        lines = [json.dumps(r) for r in self.records]
        if path is not None:
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
        return lines


@contextlib.contextmanager
def trace(log_dir):
    """Capture a profile of the enclosed block into
    ``log_dir/trace.json`` (Chrome trace format; open it in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()``
    sums the captured operations by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name):
    """Named span visible in a ``trace`` (see :func:`span`)."""
    return span(name)
