"""The program's own spans (``circuitmap_torch/utils/profiling.py``) in a
traced slice, and its request log's stages, for the per-layer readers.

A span is a host event of its name in ``Trace.host``. A program without
a span gives an empty list, and its readers None.
"""

from __future__ import annotations


def spans(trace, name):
    """[(start_us, end_us), ...] of the program's spans called ``name``,
    in order of their start."""
    return sorted((s, e) for n, s, e in trace.host if n == name)


def inside(outer, inner):
    """For each span of ``outer``, the spans of ``inner`` that start in
    it."""
    return [[(s, e) for s, e in inner if a <= s < b] for a, b in outer]


def mean_ms(durations_us):
    """The mean of a list of microseconds, in milliseconds; None for an
    empty list."""
    if not durations_us:
        return None
    return sum(durations_us) / len(durations_us) / 1e3


def span_ms(trace, name):
    """The mean length of the spans called ``name``, in milliseconds."""
    return mean_ms([e - s for s, e in spans(trace, name)])


def busy_us(trace, start, end):
    """Microseconds of [start, end] in which some device operation ran."""
    return sum(max(0.0, min(e, end) - max(s, start))
               for s, e in trace.busy_intervals)


def stage_ms(ctx, stage):
    """The mean of a stage's host seconds over the answered rows of the
    program's request log that carry it, in milliseconds."""
    rows = [r for r in (ctx.request_log or [])
            if r.get("status") == 200 and stage in r.get("stages", {})]
    if not rows:
        return None
    return 1e3 * sum(r["stages"][stage] for r in rows) / len(rows)
