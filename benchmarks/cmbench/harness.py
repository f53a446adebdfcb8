"""One run of one cell: set-up, the measured window, the check against
the plain reference, the per-layer metrics of a traced run, and the
result line.

Everything that belongs to one configuration, one traffic mix, one kind
of request, one cell or one per-layer metric lives in files of its own,
found by name: ``BENCHMARK.json`` names the cell's configuration file;
the mix is the data file ``traffic/<traffic>.json``, whose ``request``
names its kind; the kind is ``kinds/<request>.py``; the cell's limits
``limits/<cell>.json``; a per-layer metric's reader
``metrics/<metric>.py``, whose ``read(ctx)`` returns the value, or None
where the run gave it nothing to read.

A kind's module holds what is particular to its requests:

* ``BIG``: the fields of an answer kept only for the answers sampled
  from the seed;
* ``make_data(cfg, seed, device, root)``: the inputs, from the seed;
* ``Driver(cfg, traffic, data, device, root, setup)``: drives the
  program; ``request(spans)`` makes one request and returns its answer,
  ``counters()`` the program's counters, ``request_log()`` the
  program's own log of the requests (or None), ``close()`` frees it;
* ``end_to_end(traffic, window_s, answered, latencies)``: the window's
  end-to-end values by metric name (``setup_s`` is the harness's);
* ``reference(cfg, traffic, data, device)``, and
  ``numbers(cfg, traffic, ref, small, sampled)``: every number the
  check can read from the kept answers, of which the cell's limits name
  those compared;
* ``control(cfg, traffic, data, device)``: the control's answers, as
  (every answer, the sampled answers), for ``control.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "circuitmap_tpu")
# the requests at the start of a traced run's window that run under the
# profiler
TRACED_REQUESTS = 2


# ---------------------------------------------------------------------------
# The benchmark's files
# ---------------------------------------------------------------------------


class Spec:
    """The cell's entries and files."""

    def __init__(self, root, workload):
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.bench = json.load(fh)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.root = root
        self.cell = cells[workload]
        entry = next(c for c in self.bench["configs"]
                     if c["name"] == self.cell["config"])
        self.config = _json(os.path.join(root, entry["file"]))
        self.traffic = _json(os.path.join(BENCH_DIR, "traffic",
                                          self.cell["traffic"] + ".json"))
        self.limits = _json(os.path.join(BENCH_DIR, "limits",
                                         workload + ".json"))
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if _applies(m, workload)]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if _applies(m, workload)]


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def _module(folder, name):
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    key = f"cmbench_{folder}_" + name.replace(".", "_").replace("-", "_")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def kind(traffic):
    """The module of the mix's kind of request, ``kinds/<request>.py``."""
    return _module("kinds", traffic["request"])


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def card_info():
    """(name, power limit) of the first card, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return name, limit
    except Exception as exc:  # reported, not fatal: the run still counts
        return None, f"not read ({type(exc).__name__})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


class Context:
    """What a per-layer metric's reader reads: the cell, the traced
    slice (``trace``), the layer spans' device times (``spans``), the
    program's counters' growth over the slice (``launches``), the
    slice's request count, the untraced requests' latencies in seconds
    (``latencies``) and the program's own log of the untraced requests
    (``request_log``, None where the program keeps none)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Keeper:
    """The outputs kept for the check: the small fields of every answer,
    and the big ones ([N, K] spike posteriors, demixed traces) of two
    answers drawn from the seed (a reservoir sample) and of the last."""

    def __init__(self, seed, big, k=2):
        import numpy as np

        self.big = big
        self.rng = np.random.default_rng(seed)
        self.k, self.n = k, 0
        self.small, self.reservoir, self.last = [], [], None

    def add(self, out):
        self.small.append({f: v for f, v in out.items() if f not in self.big})
        if len(self.reservoir) < self.k:
            self.reservoir.append(out)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.k:
                self.reservoir[j] = out
        self.last = out
        self.n += 1

    def sampled(self):
        out = list(self.reservoir)
        if self.last is not None and all(o is not self.last for o in out):
            out.append(self.last)
        return out


def run_cell(spec, seed, seconds, trace, device, t_start, log=print):
    """One run of ``spec``'s cell on ``device``; returns a dict of the
    result's parts."""
    import torch

    from . import check
    from . import trace as tr
    from .spans import Spans

    cfg, traffic, cell = spec.config, spec.traffic, spec.cell
    K = kind(traffic)
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    setup = {"import_s": time.perf_counter() - t_start}

    t0 = time.perf_counter()
    from circuitmap_torch.ops import _build
    from circuitmap_torch.utils import native
    if on_cuda:
        _build.library()
    native.library()
    setup["library_s"] = time.perf_counter() - t0
    setup["kernel_build_s"] = _build.build_seconds
    t0 = time.perf_counter()
    data = K.make_data(cfg, seed, device, spec.root)
    sync()
    setup["data_s"] = time.perf_counter() - t0
    drv = K.Driver(cfg, traffic, data, device, spec.root, setup)
    t0 = time.perf_counter()
    n_warm = int(traffic.get("warm_requests", 1))
    for _ in range(n_warm):
        drv.request(Spans(False))
    sync()
    setup["warm_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    log("# setup " + json.dumps(setup))

    # the window: a closed loop of one client for `seconds`; a traced run
    # first runs its slice under the profiler, and its window starts once
    # the slice's trace is read (that takes seconds)
    keeper, latencies = Keeper(seed, K.BIG), []
    counts = {"attempted": 0, "failed": 0}

    def one(spans):
        t_req = time.perf_counter()
        counts["attempted"] += 1
        try:
            keeper.add(drv.request(spans))
        except Exception as exc:  # counted; the run is then not correct
            counts["failed"] += 1
            log(f"# request {counts['attempted']} failed: "
                f"{type(exc).__name__}: {exc}")
        latencies.append(time.perf_counter() - t_req)

    n_traced = TRACED_REQUESTS if trace else 0
    box, spans = [], Spans(bool(trace))
    launches0 = drv.counters()
    t_win = time.perf_counter()
    if n_traced:
        with tr.traced("window_slice", box):
            for _ in range(n_traced):
                one(spans)
        launches1 = drv.counters()
        t_win = time.perf_counter()
    while time.perf_counter() - t_win < seconds:
        one(Spans(False))
    window_s = time.perf_counter() - t_win
    sync()
    log("# window " + json.dumps({
        "seconds": window_s, "requests_ms": [round(1e3 * t, 3)
                                             for t in latencies]}))
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0

    # per-layer metrics of a traced run
    per_layer, breakdown, busy = {}, None, None
    if n_traced:
        slice_trace, read_s = box
        log_rows = drv.request_log()
        ctx = Context(cell=cell, config=cfg, traffic=traffic,
                      trace=slice_trace, spans=spans.device_ms(),
                      launches={k: launches1[k] - launches0[k]
                                for k in launches0},
                      traced_requests=n_traced,
                      latencies=latencies[n_traced:],
                      request_log=(None if log_rows is None
                                   else log_rows[n_warm + n_traced:]))
        for m in spec.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": slice_trace.top_ops(),
                     "idle_gaps": slice_trace.idle_gaps()}
        busy = (slice_trace.busy_us / 1e6, slice_trace.span_us / 1e6)
        log(f"# trace read in {read_s:.1f} s")

    # free the program's state, then the reference
    drv.close()
    del drv
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = K.reference(cfg, traffic, data, device)
    numbers = compare(spec, K.numbers(cfg, traffic, ref, keeper.small,
                                      keeper.sampled()))
    log(f"# reference and comparison {time.perf_counter() - t0:.1f} s")
    attempted, failed = counts["attempted"], counts["failed"]
    correct, lines = check.judge(numbers, spec.limits, attempted, failed)
    if trace:
        metrics = per_layer
    else:
        metrics = _end_to_end(spec, K.end_to_end(
            traffic, window_s, attempted - failed, latencies), setup_s)
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, peak=peak, busy=busy, breakdown=breakdown,
                numbers=numbers, lines=lines, setup=setup)


def compare(spec, numbers):
    """The compared numbers: those the cell's limits name."""
    return {k: v for k, v in numbers.items() if k in spec.limits}


def _end_to_end(spec, values, setup_s):
    """The cell's end-to-end metrics, by name, from the kind's values."""
    values = dict(values, setup_s=setup_s)
    missing = [m["name"] for m in spec.end_to_end if m["name"] not in values]
    if missing:
        raise RuntimeError(f"the request kind gives no {missing}")
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.end_to_end}


def result_line(res, spec, device):
    """The last line's object: the driver's keys, then the compared
    numbers beside their limits under a key of their own, last."""
    device = dict(device)
    if res["busy"] is not None:
        device["busy_s"], device["window_s"] = res["busy"]
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": res["metrics"],
           "device": device}
    if res["breakdown"] is not None:
        out["breakdown"] = res["breakdown"]
    out["compared"] = {k: {"value": v, "limit": spec.limits.get(k)}
                       for k, v in sorted(res["numbers"].items())}
    return out


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------


def main(argv, t_start, root):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = Spec(root, args.workload)

    import torch
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: this cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(spec, args.seed, args.seconds, args.trace, "cuda",
                   t_start, log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    name, power_limit = card_info()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(res["peak"]),
              "power_limit": power_limit, "smi_name": name}
    for line in res["lines"]:
        print(line, file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result_line(res, spec, device)), flush=True)
    return 0
