"""Locate the single-card memory cliff of the CAVIaR fit path (port of
``scripts_tpu/probe_memory_cliff.py``).

The fit's device working set is dominated by the [N, K] arrays (the
stimulus design, the spike posterior lam, the sweep's output and the
prep path's temporaries: a few live copies of 4*N*K bytes in float32).
For a ladder of shapes this launches ONE SUBPROCESS per shape (a CUDA
out-of-memory must not poison the caching allocator for the next
probe), synthesises a random hologram design + traces (no full
simulation: only the footprint matters here), runs a short public
``caviar()`` fit, and records ok / oom. The ladder starts at the JAX
script's first rung (N=2000, K=100,000) and doubles N until a rung
fails. Only the card's out-of-memory counts as the cliff: a child that
the host's memory stops (MemoryError, killed, or stopped by this
script's watchdog past ``HOST_FRACTION`` of the host's memory, so that
the machine itself never runs out) is recorded as ``host_oom``. Where
the host, not the card, stopped the N leg (above N=32,766 the stim
upload leaves the int16 hologram form for a dense host bucket matrix,
several bytes an element), a K leg follows at the last N that fit: K
grows by a quarter a rung until the card runs out. Then
``BISECTIONS`` rungs halve the gap between the last fit and the card's
first out-of-memory. Results go to
MEMORY_CLIFF_H100.json with the JAX file's keys; ``device`` names the
card and its power limit.

Shapes past the cliff route to the trial-sharded solvers
(``parallel/sharded.py``: every [.., K] array partitions over the mesh)
or, across processes, to ``parallel/distributed.py``.

    python -m circuitmap_torch memory-cliff [--quick] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from . import add_device_argument

FIRST_RUNG = (2000, 100_000)   # 0.8 GB per [N, K] float32 array
MAX_N = 1_024_000              # the doubling stops here whatever happens
BISECTIONS = 2                 # rungs between the last fit and a failure
HOST_FRACTION = 0.7            # the watchdog's share of the host's memory

_CHILD = """
import json, sys, time
import numpy as np

N, K, device = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
rng = np.random.default_rng(0)
try:
    # hologram design: H=10 targets/trial, 3 power levels (bench protocol)
    H, powers = 10, np.array([45.0, 55.0, 65.0], np.float32)
    stim = np.zeros((N, K), np.float32)
    cols = np.repeat(np.arange(K), H)
    rows = rng.integers(0, N, size=K * H)
    stim[rows, cols] = rng.choice(powers, size=K * H)
    # traces: random PSC-scale noise; footprint (not recovery) is measured
    traces = rng.standard_normal((K, 900)).astype(np.float32) * 0.01
except MemoryError:
    print(json.dumps({"ok": False, "oom": False, "host_oom": True,
                      "error": "MemoryError building the design"}))
    sys.exit(3)

import torch
from circuitmap_torch.model import default_priors
from circuitmap_torch.solvers import caviar

p = default_priors(N)
t0 = time.time()
try:
    out = caviar(traces, stim, p["mu"], p["beta"], p["shape"], p["rate"],
                 p["phi"], p["phi_cov"], iters=2, msrmp=0.3,
                 powers=[45.0, 55.0, 65.0], trace_wire="int8",
                 fn_scan=False, verbose=False, device=device)
    np.asarray(out[0][:1].cpu())
except torch.cuda.OutOfMemoryError as exc:
    print(json.dumps({"ok": False, "oom": True, "host_oom": False,
                      "error": str(exc).splitlines()[0][:300]}))
    sys.exit(3)
except MemoryError:
    print(json.dumps({"ok": False, "oom": False, "host_oom": True,
                      "error": "MemoryError during the fit"}))
    sys.exit(3)
peak = (torch.cuda.max_memory_allocated() / 1e9
        if torch.device(device).type == "cuda" else None)
print(json.dumps({"ok": True, "seconds": round(time.time() - t0, 1),
                  "peak_device_gb": None if peak is None else round(peak, 2)}))
"""


def _device_name(device):
    """The card's name and power limit (nvidia-smi), or the device."""
    if device.type != "cuda":
        return str(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def _host_kb(field, pid="self"):
    """A /proc memory field in kB (MemTotal of meminfo, VmRSS of a
    process), or None where /proc does not say."""
    path = "/proc/meminfo" if field == "MemTotal" else f"/proc/{pid}/status"
    try:
        with open(path) as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def _run_watched(cmd, timeout, env):
    """Run ``cmd``; kill it past ``timeout`` seconds or past
    HOST_FRACTION of the host's memory. Returns (rc, output, verdict,
    peak_rss_gb): verdict None, "timeout" or "host"."""
    limit = _host_kb("MemTotal")
    limit = None if limit is None else HOST_FRACTION * limit
    with subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          env=env) as proc:
        out = []
        reader = threading.Thread(target=lambda: out.append(
            proc.stdout.read()), daemon=True)
        reader.start()
        t0, peak, verdict = time.time(), 0, None
        while proc.poll() is None:
            rss = _host_kb("VmRSS", proc.pid) or 0
            peak = max(peak, rss)
            if limit is not None and rss > limit:
                verdict = "host"
            elif time.time() - t0 > timeout:
                verdict = "timeout"
            if verdict:
                proc.kill()
                break
            time.sleep(0.2)
        proc.wait()
        reader.join()
    return proc.returncode, "".join(out), verdict, round(peak / 1e6, 2)


def probe(N, K, device, timeout):
    """One rung in a fresh interpreter: its row of the results."""
    gb = 4 * N * K / 1e9
    print(f"probe N={N} K={K} ({gb:.1f} GB per [N,K] array)...", flush=True)
    repo = str(Path(__file__).resolve().parents[2])
    env = {**os.environ,
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.time()
    rc, text, verdict, peak_host = _run_watched(
        [sys.executable, "-c", _CHILD, str(N), str(K), str(device)],
        timeout, env)
    wall = round(time.time() - t0, 1)
    tail = text.strip().splitlines()
    # the result line may not be LAST: the child's stderr (warnings) is
    # concatenated after stdout
    marks = [ln for ln in tail if ln.startswith('{"ok"')]
    last = marks[-1] if marks else (tail[-1] if tail else "")
    row = dict(N=N, K=K, gb_per_array=round(gb, 2))
    if marks:
        row.update(wall_seconds=wall, **json.loads(last))
    elif verdict == "host":
        row.update(ok=False, oom=False, host_oom=True, wall_seconds=wall,
                   error=f"host memory past {HOST_FRACTION:.0%} of the "
                         "host's: stopped by the watchdog")
    elif verdict == "timeout":
        row.update(ok=False, oom=False, host_oom=False, wall_seconds=wall,
                   error="timeout after %ds" % timeout)
    else:
        # no verdict from the child: a signal (the host's OOM killer sends
        # SIGKILL) or another failure
        killed = rc is not None and rc < 0
        row.update(ok=False, oom=False, host_oom=killed, wall_seconds=wall,
                   error=(f"killed by signal {-rc}" if killed
                          else last[-300:] if last else "no output"))
    row["peak_host_gb"] = peak_host
    print(json.dumps(row), flush=True)
    return row


def ladder(device, timeout, quick):
    """The rungs: N doubling from FIRST_RUNG until a rung fails; after a
    host-side failure, K growing by a quarter at the last N that fit;
    then BISECTIONS rungs halving the gap between the last fit and the
    card's first out-of-memory on the leg that reached it."""
    N, K = FIRST_RUNG
    results = [probe(N, K, device, timeout)]
    if quick:
        return results
    while results[-1]["ok"] and N * 2 <= MAX_N:
        N *= 2
        results.append(probe(N, K, device, timeout))
    leg = "N"
    if results[-1].get("host_oom") and any(r["ok"] for r in results):
        leg, N = "K", max(r["N"] for r in results if r["ok"])
        while results[-1]["ok"] or results[-1]["N"] != N:
            K = K * 5 // 4
            results.append(probe(N, K, device, timeout))
            if not results[-1]["ok"] and not results[-1].get("oom"):
                return results  # the host or a timeout again: no cliff
    on_leg = [r for r in results if (r["K"] if leg == "N" else r["N"])
              == (FIRST_RUNG[1] if leg == "N" else N)]
    for _ in range(BISECTIONS):
        fit = max((r[leg] for r in on_leg if r["ok"]), default=None)
        failed = min((r[leg] for r in on_leg if r.get("oom")
                      and fit is not None and r[leg] > fit), default=None)
        if fit is None or failed is None or failed - fit < 2:
            break
        mid = (fit + failed) // 2
        row = probe(mid if leg == "N" else N, K if leg == "N" else mid,
                    device, timeout)
        results.append(row)
        on_leg.append(row)
    return results


def main(argv=None):
    from .._device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch memory-cliff", description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="first ladder rung only (harness smoke test)")
    ap.add_argument("--out", default="MEMORY_CLIFF_H100.json")
    ap.add_argument("--timeout", type=int, default=900)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    results = ladder(device, args.timeout, args.quick)
    with open(args.out, "w") as f:
        json.dump(dict(device=_device_name(device),
                       protocol="caviar iters=2, int8 trace wire, "
                                "H=10 hologram design, fn_scan off",
                       results=results), f, indent=1)
    print(f"wrote {args.out}")
