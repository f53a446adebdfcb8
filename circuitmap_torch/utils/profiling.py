"""Profiling and structured timing (port of
``circuitmap_tpu/utils/profiling.py``).

  * ``Metrics`` — named wall-clock spans and scalar metrics collected
    into a list of records (JSON-lines friendly), host-only;
  * ``trace`` — a ``torch.profiler`` capture of the enclosed block
    (CPU and, where there is a card, CUDA activity), written as a Chrome
    trace into ``log_dir``;
  * ``annotate`` — a named ``torch.profiler.record_function`` span that
    shows up inside such a trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class Metrics:
    """Accumulates named timing spans + scalar metrics; dumps JSON lines."""

    def __init__(self):
        self.records = []

    @contextlib.contextmanager
    def span(self, name, **extra):
        t0 = time.time()
        try:
            yield
        finally:
            self.records.append(
                {"name": name, "seconds": time.time() - t0, **extra}
            )

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


@contextlib.contextmanager
def annotate(name):
    """Named span visible in a ``trace`` (a ``record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
