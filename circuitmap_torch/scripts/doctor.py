"""Environment / GPU diagnostics: ``python -m circuitmap_torch doctor``
(port of ``scripts_tpu/doctor.py``).

Deployments of the fit path fail in ways that look alike from the API (a
hang, or a CUDA error): no usable GPU, a driver that does not answer,
no ``nvcc`` to build the kernels, a missing demixer checkpoint. This
command probes each layer and prints one PASS/WARN/FAIL line per check;
exit code 0 iff no FAIL.

The GPU probe runs in a *subprocess with a timeout*: a CUDA call against
a wedged driver can block forever, so the probe must be hang-proof and
must not take this process's CUDA context with it. Results are parsed
from marker lines in the child's stdout (stderr can interleave
arbitrarily with library logging). Without a GPU the accelerator check
FAILs: it never passes by running on the CPU. ``--device cpu`` says that
the CPU is the intended device, so a kernel library that cannot be built
here is a WARN, not a FAIL.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from . import add_device_argument

PASS, WARN, FAIL, SKIP = "PASS", "WARN", "FAIL", "SKIP"

_REPO = Path(__file__).resolve().parents[2]


def _run_probe(code, timeout):
    """Run ``code`` in a fresh interpreter from the repository root;
    return (stdout, err_string): err_string is None on rc==0, else a
    short diagnosis ("timeout" or the tail of stderr). One shared
    hang-proof core with hw-smoke (circuitmap_torch.utils.probes)."""
    from ..utils.probes import run_probe_cmd

    return run_probe_cmd([sys.executable, "-c", code], timeout,
                         cwd=str(_REPO))


def _marker(stdout, key):
    """Scan stdout for a ``KEY value...`` marker line (not the last
    line: libraries may still print)."""
    for line in stdout.splitlines():
        if line.startswith(key + " "):
            return line[len(key) + 1:].strip()
        if line.strip() == key:
            return ""
    return None


# ---------------------------------------------------------------- checks

def check_versions():
    import numpy
    import torch

    from .. import __version__

    detail = {"python": sys.version.split()[0], "torch": torch.__version__,
              "torch_cuda": torch.version.cuda or "none (CPU build)",
              "numpy": numpy.__version__, "circuitmap_torch": __version__}
    return PASS, detail


def check_host():
    detail = {"cpus": os.cpu_count()}
    try:
        detail["loadavg_1m"] = round(os.getloadavg()[0], 2)
    except OSError:
        pass
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    detail["mem_available_gb"] = round(
                        int(line.split()[1]) / 1e6, 1)
                    break
    except OSError:
        pass
    # Competing python workloads: on a small host they halve each
    # other's throughput, and two processes on one card share its
    # memory — warn, don't fail.
    others = []
    try:
        out = subprocess.run(["ps", "-eo", "pid,comm,args"],
                             capture_output=True, text=True, timeout=10)
        me = {os.getpid(), os.getppid()}
        for line in out.stdout.splitlines()[1:]:
            parts = line.split(None, 2)
            if len(parts) < 3:
                continue
            pid, comm, args = parts
            if "python" in comm and int(pid) not in me \
                    and "doctor" not in args:
                others.append(args[:80])
    except Exception:
        pass
    if others:
        detail["competing_python"] = others[:5]
        return WARN, detail
    return PASS, detail


def check_native(device):
    """The CUDA kernel library: built for this source hash, and nvcc."""
    from ..ops import _build

    lib = _build.library_path()
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    detail = {"built": lib.exists(), "library": lib.name,
              "nvcc": nvcc or "not found"}
    if lib.exists():
        return PASS, detail
    if nvcc:
        detail["hint"] = ("not built yet: the first GPU fit builds it "
                          "(nvcc, ~30 s); build it now with `python -m "
                          "circuitmap_torch warm-cache`")
        return WARN, detail
    detail["hint"] = ("no library for these sources and no nvcc to build "
                      "one: GPU fits cannot run (install the CUDA toolkit "
                      "or set CUDA_HOME); CPU fits (device='cpu') are "
                      "unaffected")
    return (WARN if device.type == "cpu" else FAIL), detail


def check_zoo():
    zoo = _REPO / "demixers"
    ckpts = sorted(p.name for p in zoo.glob("*.npz")) if zoo.is_dir() else []
    detail = {"checkpoints": len(ckpts)}
    if not ckpts:
        detail["hint"] = ("no demixers/*.npz found — train one with "
                          "`python -m circuitmap_torch train-demixer` or "
                          "convert a reference .ckpt")
        return WARN, detail
    detail["qat_int4"] = sorted(n for n in ckpts if "int4" in n)
    return PASS, detail


def check_compile_cache():
    """The build directory (the counterpart of XLA's compile cache)."""
    from .. import default_compile_cache_dir
    from ..ops._build import BUILD_DIR_ENV

    # probe the SAME path the runtime writes (ops/_build.py), so the
    # diagnostic cannot drift from the behaviour it diagnoses
    cache = Path(default_compile_cache_dir())
    detail = {"dir": str(cache), "env": bool(os.environ.get(BUILD_DIR_ENV))}
    entries = sorted(cache.glob("*.so")) if cache.is_dir() else []
    detail["entries"] = len(entries)
    if entries:
        detail["size_mb"] = round(
            sum(p.stat().st_size for p in entries) / 1e6, 1)
        return PASS, detail
    detail["hint"] = ("cold build directory: the first GPU fit pays the "
                      "nvcc build; pre-build with `python -m "
                      "circuitmap_torch warm-cache`")
    return WARN, detail


_ACCEL_PROBE = r"""
import subprocess, time, numpy as np, torch
try:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
except OSError:
    smi = []
print("SMI", smi[0] if smi else "unavailable")
assert torch.cuda.is_available(), (
    "torch.cuda.is_available() is False: no usable CUDA device")
dev = torch.device("cuda")
print("PLATFORM gpu %s n=%d" % (torch.cuda.get_device_name(0),
                                torch.cuda.device_count()))
x = torch.ones((128, 128), device=dev)
y = (x @ x)[0, 0].item()                      # forced pull = real settle
assert abs(y - 128.0) < 1e-3
one = torch.zeros(1, device=dev)
rtts = []
for _ in range(5):
    t0 = time.perf_counter()
    one.add_(1.0).item()
    rtts.append(time.perf_counter() - t0)
print("RTT_MS %.3f" % (sorted(rtts)[2] * 1e3))
# a host-device round trip of random data; the first transfer of a new
# shape is unrepresentative, so time the second
rng = np.random.default_rng(0)
buf = torch.from_numpy(rng.standard_normal(NFLOATS).astype(np.float32))
buf.to(dev).cpu()
buf2 = torch.from_numpy(rng.standard_normal(NFLOATS).astype(np.float32))
torch.cuda.synchronize()
t0 = time.perf_counter()
d2 = buf2.to(dev)
torch.cuda.synchronize()
t1 = time.perf_counter()
back = d2.cpu()
t2 = time.perf_counter()
assert torch.equal(back, buf2), "the round trip changed the data"
print("UPLOAD_MBPS %.1f" % (buf2.numel() * 4 / (t1 - t0) / 1e6))
print("DOWNLOAD_MBPS %.1f" % (buf2.numel() * 4 / (t2 - t1) / 1e6))
print("DOCTOR_ACCEL_OK")
"""


def check_accelerator(timeout, probe_mb):
    nfloats = max(1, int(probe_mb * 1e6 / 4))
    stdout, err = _run_probe(
        _ACCEL_PROBE.replace("NFLOATS", str(nfloats)), timeout)
    if err is not None or _marker(stdout, "DOCTOR_ACCEL_OK") is None:
        detail = {"error": err or "probe did not complete"}
        smi = _marker(stdout, "SMI")
        if smi:
            detail["nvidia_smi"] = smi
        detail["hint"] = (
            "GPU probe failed — if this host normally has a GPU, its "
            "driver is down or busy; the port never falls back to the "
            "CPU by itself: run on the CPU with device='cpu' (--device "
            "cpu on the commands)")
        return FAIL, detail
    detail = {"device": _marker(stdout, "PLATFORM"),
              "nvidia_smi": _marker(stdout, "SMI")}
    for key, marker in (("roundtrip_ms", "RTT_MS"),
                        ("upload_mb_s", "UPLOAD_MBPS"),
                        ("download_mb_s", "DOWNLOAD_MBPS")):
        value = _marker(stdout, marker)
        if value:
            detail[key] = float(value)
    status = PASS
    if detail.get("roundtrip_ms", 0.0) > 200.0:
        detail["note"] = "high round-trip latency; expect slow dispatch"
        status = WARN
    return status, detail


_CPU_PROBE = r"""
import numpy as np
import circuitmap_torch as cm
np.random.seed(0)
sim = cm.simulate(N=16, trials=200, H=2, connection_prob=0.2,
                  verbose=False, device="cpu")
model = cm.Model(16).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                         fit_options={"iters": 3, "verbose": False})
assert np.isfinite(model.state["mu"]).all()
print("DOCTOR_CPU_OK")
"""


def check_cpu_fallback(timeout):
    """A CPU fit runs when asked for with device='cpu'."""
    stdout, err = _run_probe(_CPU_PROBE, timeout)
    if err is not None or _marker(stdout, "DOCTOR_CPU_OK") is None:
        return FAIL, {"error": err or "probe did not complete"}
    return PASS, {"fit": "ok"}


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch doctor",
        description="diagnose the circuitmap_torch runtime environment")
    parser.add_argument("--timeout", type=float, default=90.0,
                        help="per-probe subprocess timeout, seconds "
                             "(a wedged driver can hang forever; "
                             "default 90)")
    parser.add_argument("--probe-mb", type=float, default=4.0,
                        help="size of the host-device round-trip probe "
                             "(MB)")
    parser.add_argument("--skip-accelerator", action="store_true",
                        help="skip the GPU probe (e.g. in CI or on a "
                             "known-CPU host)")
    parser.add_argument("--json", dest="json_out", default=None,
                        help="also write results as JSON to this path "
                             "('-' for stdout)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)

    checks = [
        ("versions", check_versions, ()),
        ("host", check_host, ()),
        ("native-lib", check_native, (device,)),
        ("demixer-zoo", check_zoo, ()),
        ("compile-cache", check_compile_cache, ()),
        ("cpu-fallback", check_cpu_fallback, (args.timeout,)),
    ]
    if args.skip_accelerator:
        checks.append(("accelerator", None, ()))
    else:
        checks.append(("accelerator", check_accelerator,
                       (args.timeout, args.probe_mb)))

    results = {}
    t_all = time.perf_counter()
    for name, fn, fargs in checks:
        if fn is None:
            status, detail = SKIP, {"reason": "--skip-accelerator"}
        else:
            try:
                status, detail = fn(*fargs)
            except Exception as exc:  # a broken check is a finding too
                status, detail = FAIL, {"error": "%s: %s" % (
                    type(exc).__name__, exc)}
        results[name] = {"status": status, **detail}
        parts = ", ".join(
            "%s=%s" % (k, v) for k, v in detail.items()
            if k not in ("hint", "note", "error"))
        print("%-5s %-14s %s" % (status, name, parts))
        for key in ("error", "note", "hint"):
            if key in detail:
                print("      %s: %s" % (key, detail[key]))
    print("doctor: %d checks in %.1fs" % (
        len(checks), time.perf_counter() - t_all))

    if args.json_out:
        payload = json.dumps(results, indent=2, default=str)
        if args.json_out == "-":
            print(payload)
        else:
            Path(args.json_out).write_text(payload)

    return 1 if any(r["status"] == FAIL for r in results.values()) else 0
