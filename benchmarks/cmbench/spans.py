"""CUDA events around the benchmark's own calls into each layer."""

from __future__ import annotations

import torch


class Spans:
    """CUDA events around the calls into each layer of one request, read
    after the slice: a layer's device time runs from its call's start to
    the end of the work the call enqueued."""

    def __init__(self, on):
        self.on = on and torch.cuda.is_available()
        self.marks = []

    def mark(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def device_ms(self):
        """{layer: [ms, ...]} for consecutive marks ``<layer>`` ->
        ``<layer>.end``."""
        if not self.on:
            return {}
        torch.cuda.synchronize()
        out = {}
        for (a, ea), (b, eb) in zip(self.marks, self.marks[1:]):
            if b == a + ".end":
                out.setdefault(a, []).append(ea.elapsed_time(eb))
        return out
