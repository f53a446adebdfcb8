"""Reading a ``torch.profiler`` trace of a slice of the window.

The idle-share arithmetic (1 - the union of the device's operation
intervals over the traced span) and the top device operations by total
time are copied from ``chip_smoke.py::profiled`` at commit
2a4eea50fb68982d273bbeba2057be11d71ede01.
"""

from __future__ import annotations

import bisect
import contextlib
import time

NAME_CHARS = 160  # an operation's name as the breakdown gives it


class Trace:
    """The device operations and host events of one traced slice.

    ``ops``: (name, start_us, end_us) of every operation that ran on the
    device; ``host``: (name, start_us, end_us) of the host's events;
    ``span_us``: the slice's length on the same clock."""

    def __init__(self, ops, host, start_us, end_us):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.host = host
        self.start_us, self.end_us = start_us, end_us
        self.span_us = end_us - start_us
        self.busy_intervals = _union([(s, e) for _, s, e in self.ops])
        self.busy_us = sum(e - s for s, e in self.busy_intervals)

    @property
    def idle_share(self):
        return 1.0 - self.busy_us / self.span_us

    def op_totals(self, contains=None):
        """{name: (total_us, count)} of the device operations, those
        whose name holds ``contains`` when given."""
        out = {}
        for name, s, e in self.ops:
            if contains is None or contains in name:
                tot, n = out.get(name, (0.0, 0))
                out[name] = (tot + (e - s), n + 1)
        return out

    def top_ops(self, n=10):
        """[[name, seconds], ...] of the device operations with the most
        total time."""
        rows = sorted(self.op_totals().items(), key=lambda kv: -kv[1][0])
        return [[name[:NAME_CHARS], tot / 1e6]
                for name, (tot, _) in rows[:n]]

    def idle_gaps(self, n=10):
        """[[label, seconds], ...] of the longest idle gaps on the device,
        each labelled by the innermost host event under way at its
        middle (what the host was doing while the device waited)."""
        edges = [self.start_us]
        for s, e in self.busy_intervals:
            edges += [s, e]
        edges.append(self.end_us)
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        out = []
        for length, s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            label, best = "host, outside any torch operation", None
            for name, hs, he in host[:bisect.bisect_right(starts, mid)]:
                if he >= mid and (best is None or he - hs < best):
                    label, best = name, he - hs
            out.append([label[:NAME_CHARS], length / 1e6])
        return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def traced(label, box):
    """Profile the block (host and CUDA activities) inside a ``label``
    annotation; on exit, ``box`` holds the block's :class:`Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_cuda else [])) as prof:
        with record_function(label):
            yield
            sync()
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the annotation shows on the device's timeline too: not device work
    span = next(e.time_range for e in events
                if e.name == label and e.device_type != cuda)
    ops, host = [], []
    for e in events:
        r = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if e.name != label:
                ops.append(r)
        elif e.name != label:
            host.append(r)
    box.append(Trace(ops, host, span.start, span.end))
    box.append(time.perf_counter() - t0)  # seconds spent reading it
