"""Build and load the port's CUDA kernels.

Every ``circuitmap_torch/csrc/*.cu`` compiles with nvcc for sm_90a into
one shared library with a plain C interface, loaded with ``ctypes``.
Sources compile in parallel (one nvcc per source, all started together)
and link once. The library lands in ``circuitmap_torch/_build/`` under a
name that hashes the sources and flags, so an unchanged tree reuses it
and an edited one rebuilds. Nothing builds at import time: the first
kernel launch calls :func:`library`. No ``--use_fast_math``: the Laplace
kernel relies on IEEE NaN semantics (log of a negative step candidate).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: cached)


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "circuitmap_torch CUDA kernels are built from source at first use "
        "and need the CUDA toolkit")


def _digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def _build(target, sources):
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(sources, objs)])
        tmp_lib = Path(tmp) / target.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(tmp_lib)]])
        os.replace(tmp_lib, target)  # atomic: concurrent builders agree


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            sources = _sources()
            target = BUILD_DIR / f"libcircuitmap_torch_{_digest(sources)}.so"
            if not target.exists():
                t0 = time.time()
                _build(target, sources)
                build_seconds = time.time() - t0
            _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # E, N, K, P, nsteps, rows_per_step, then cluster_plan's cluster,
    # cols, on_chip, depth, smem_bytes
    lib.cm_sweep_cluster_f32.argtypes = [p] * 14 + [i] * 11 + [p]
    lib.cm_sweep_cluster_f32.restype = i
    lib.cm_sweep_cluster_active.argtypes = [i] * 5
    lib.cm_sweep_cluster_active.restype = i
    lib.cm_laplace_f32.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.cm_laplace_f32.restype = i
    lib.cm_error_string.argtypes = [i]
    lib.cm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err, what):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
