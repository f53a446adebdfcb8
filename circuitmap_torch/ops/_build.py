"""Build and load the port's CUDA kernels.

Every ``circuitmap_torch/csrc/*.cu`` compiles with nvcc for sm_90a into
one shared library with a plain C interface, loaded with ``ctypes``.
Sources compile in parallel (one nvcc per source, all started together)
and link once. The library lands in the build directory,
``circuitmap_torch/_build/`` unless ``$CIRCUITMAP_TORCH_BUILD_DIR``
names another (the counterpart of the JAX package's
``JAX_COMPILATION_CACHE_DIR``; ``warm-cache --cache-dir`` sets it),
under a name that hashes the sources and flags, so an unchanged tree
reuses it and an edited one rebuilds. Nothing builds at import time: the first
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
BUILD_DIR_ENV = "CIRCUITMAP_TORCH_BUILD_DIR"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: cached)


def build_dir():
    """The build directory: ``$CIRCUITMAP_TORCH_BUILD_DIR``, else
    ``circuitmap_torch/_build``."""
    return Path(os.environ.get(BUILD_DIR_ENV) or _PKG / "_build")


def library_path():
    """Where the library for this tree's sources and flags lives (built
    or not)."""
    return build_dir() / f"libcircuitmap_torch_{_digest(_sources())}.so"


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
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
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
            target = library_path()
            if not target.exists():
                t0 = time.time()
                _build(target, _sources())
                build_seconds = time.time() - t0
            _lib = _declare(ctypes.CDLL(str(target)))
        return _lib


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # E, N, K, P, nsteps, rows_per_step, block, subs, then cluster_plan's
    # cluster, cols, on_chip, depth, smem_bytes
    for fn in (lib.cm_sweep_cluster_f32, lib.cm_sweep_cluster_f64):
        fn.argtypes = [p] * 16 + [i] * 13 + [p]
        fn.restype = i
    for fn in (lib.cm_sweep_cluster_active, lib.cm_sweep_cluster_active_f64):
        fn.argtypes = [i] * 5
        fn.restype = i
    for fn in (lib.cm_laplace_f32, lib.cm_laplace_f64):
        fn.argtypes = [p] * 7 + [i] * 4 + [p]
        fn.restype = i
    # h, skip, lo, hi, frac, out, then B, C, Cs, L_in, L_out, G, share
    # (long long), vec, staged
    for fn in (lib.cm_relu_resize_cat_f32, lib.cm_relu_resize_cat_f64,
               lib.cm_relu_resize_cat_bf16, lib.cm_relu_resize_cat_f16):
        fn.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_longlong, i, i, p]
        fn.restype = i
    # lam, row_ptr, row_trials, row_pos, trial_ptr, targets, trials, vals,
    # G, then N, K, nnz, stride, width, gather_blocks
    for fn in (lib.cm_costim_gram_f32, lib.cm_costim_gram_f64):
        fn.argtypes = [p] * 9 + [i] * 6 + [p]
        fn.restype = i
    lib.cm_error_string.argtypes = [i]
    lib.cm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, err, what):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.cm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
