"""ctypes bindings of the port's host library (port of
``circuitmap_tpu/utils/native.py``).

``circuitmap_torch/native/windowing.cpp`` is host C++ that replaces
numpy passes on the host: it streams each row once on every core.

* ``extract_windows(timeline, stim_times, pre, width)`` -> [K, W] f32
* ``trapz_rows(traces)`` -> [K] f64 charges
* ``extract_windows_with_charge(...)`` -> (windows, charges)
* ``sparsify_stim(stim, levels, h_cap)``: the stim's hologram form
* ``encode_traces_int4`` / ``encode_traces_int8``: the trace wires
* ``decode_traces_int4``: the int4/int4d2 wire back to dense f32

Each returns what the JAX module's function returns when its library is
loaded, bit for bit. The library is built with g++ at first use into the
kernels' build directory (``ops/_build.build_dir()``) under a name that
hashes the source and the flags, written to a temporary file and moved
into place, so processes that build at once agree; it is loaded once per
process and build directory, under a lock. There is no fallback: a failed build or load
raises RuntimeError with g++'s output. The ``*_plain`` functions are the
numpy versions of the same functions, kept to hold the library against
(tests, ``chip_smoke.py``); no path of the package calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "windowing.cpp"
COMPILER = "g++"
# -ffp-contract=off keeps the codes bit-identical to numpy's: an FMA
# contraction changes the rounding of x / scale and of the upsample
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]

_lock = threading.Lock()

_MISMATCH = ("stim contains stimulation values not covered by the level "
             "table {}; pass the exact powers= used in the experiment (or "
             "omit powers=)")
_NON_FINITE = ("traces contain non-finite samples (or peaks above float32 "
               "range); the {} requires finite traces")


def library_path():
    """Where the library for this source and these flags lives (built or
    not)."""
    from ..ops._build import build_dir

    h = hashlib.sha256(" ".join([COMPILER, *CXX_FLAGS]).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libcircuitmap_host_{h.hexdigest()[:16]}.so"


def _build(target):
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        tmp_lib = Path(tmp) / target.name
        cmd = [COMPILER, *CXX_FLAGS, str(SOURCE), "-o", str(tmp_lib)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"the host library could not be built: {COMPILER!r} did not "
                f"run ({exc}). circuitmap_torch builds "
                "circuitmap_torch/native/windowing.cpp with g++ at first "
                "use: install g++, or run `python -m circuitmap_torch "
                "warm-cache` where it is installed and share the build "
                "directory ($CIRCUITMAP_TORCH_BUILD_DIR)") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                "the host library failed to build:\n$ " + " ".join(cmd)
                + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp_lib, target)  # atomic: concurrent builds agree


def _declare(lib):
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i16p = ctypes.POINTER(ctypes.c_int16)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cm_extract_windows.argtypes = [f32p, i64, i64p, i64, i64, i64, f32p]
    lib.cm_extract_windows.restype = None
    lib.cm_trapz_rows.argtypes = [f32p, i64, i64, f64p]
    lib.cm_trapz_rows.restype = None
    lib.cm_extract_windows_with_charge.argtypes = [
        f32p, i64, i64p, i64, i64, i64, f32p, f64p]
    lib.cm_extract_windows_with_charge.restype = None
    for fn, stim_p in ((lib.cm_sparsify_stim2_f64, f64p),
                       (lib.cm_sparsify_stim2_f32, f32p)):
        fn.argtypes = [stim_p, i64, i64, i64, f32p, i64, i64, i16p, i8p,
                       f64p]
        fn.restype = i64
    for bits in (4, 8):
        for suffix, src_p in (("f64", f64p), ("f32", f32p)):
            fn = getattr(lib, f"cm_encode_traces_int{bits}_{suffix}")
            fn.argtypes = [src_p, i64, i64, i64, u8p, f32p]
            fn.restype = i64
    lib.cm_decode_traces_int4.argtypes = [u8p, i64, i64, i64, f32p, f32p]
    lib.cm_decode_traces_int4.restype = i64
    return lib


_libs = {}  # path -> the library loaded from it
built = None  # whether the last load built the library (None before it)


def library():
    """The loaded host library of the current build directory, built
    there on first call (``built`` then says whether this call built it
    or found it). Raises RuntimeError when it cannot be built or
    loaded."""
    global built
    target = library_path()
    with _lock:
        if target not in _libs:
            built = not target.exists()
            if built:
                _build(target)
            try:
                _libs[target] = _declare(ctypes.CDLL(str(target)))
            except (OSError, AttributeError) as exc:
                raise RuntimeError(
                    f"the host library {target} does not load ({exc}); "
                    "delete it to have it built again") from exc
        return _libs[target]


def native_available():
    """True iff the library is built for this source, or g++ can build
    it (which this call then does)."""
    try:
        library()
    except RuntimeError:
        return False
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as_f32(a):
    return np.ascontiguousarray(a, dtype=np.float32)


def extract_windows(timeline, stim_times, pre=100, width=900):
    """[K, W] response windows starting ``pre`` samples before each stim
    time; zero-padded at the recording's edges."""
    lib = library()
    timeline = _as_f32(timeline)
    stim_times = np.ascontiguousarray(stim_times, dtype=np.int64)
    K = stim_times.size
    out = np.empty((K, width), dtype=np.float32)
    lib.cm_extract_windows(
        _ptr(timeline, ctypes.c_float), timeline.size,
        _ptr(stim_times, ctypes.c_int64), K, pre, width,
        _ptr(out, ctypes.c_float))
    return out


def trapz_rows(traces):
    """Per-row trapezoidal charge of a [K, W] block (f64 accumulate)."""
    lib = library()
    traces = _as_f32(traces)
    K, W = traces.shape
    out = np.empty(K, dtype=np.float64)
    lib.cm_trapz_rows(_ptr(traces, ctypes.c_float), K, W,
                      _ptr(out, ctypes.c_double))
    return out


def extract_windows_with_charge(timeline, stim_times, pre=100, width=900):
    """Windows and their charges in one parallel pass."""
    lib = library()
    timeline = _as_f32(timeline)
    stim_times = np.ascontiguousarray(stim_times, dtype=np.int64)
    K = stim_times.size
    windows = np.empty((K, width), dtype=np.float32)
    charges = np.empty(K, dtype=np.float64)
    lib.cm_extract_windows_with_charge(
        _ptr(timeline, ctypes.c_float), timeline.size,
        _ptr(stim_times, ctypes.c_int64), K, pre, width,
        _ptr(windows, ctypes.c_float), _ptr(charges, ctypes.c_double))
    return windows, charges


def sparsify_stim(stim_np, levels_np, h_cap):
    """The hologram form of a dense [N, K] stim in one parallel pass:
    (targets int16 [H, K], -1 padded; tbucket int8 [H, K]; power_counts
    f64 [N, P]), within each column in ascending neuron order. None when
    the stim is neither float32 nor float64, when N > 32,766 (targets
    are int16) or when nothing is stimulated; the string "overflow" when
    some column holds more than ``h_cap`` targets. Raises ValueError when
    the stim holds a value missing from the level table. Both memory
    layouts are read in place (``simulate`` returns its design
    Fortran-ordered)."""
    N, K = stim_np.shape
    if N > 32766:
        return None
    lib = library()
    if stim_np.flags["C_CONTIGUOUS"]:
        f_layout = 0
    elif stim_np.flags["F_CONTIGUOUS"]:
        f_layout = 1
    else:
        stim_np = np.ascontiguousarray(stim_np)
        f_layout = 0
    if stim_np.dtype == np.float64:
        fn, cptr = lib.cm_sparsify_stim2_f64, ctypes.c_double
    elif stim_np.dtype == np.float32:
        fn, cptr = lib.cm_sparsify_stim2_f32, ctypes.c_float
    else:
        return None
    levels = np.ascontiguousarray(levels_np, dtype=np.float32)
    h_cap = int(max(h_cap, 1))
    targets = np.full((h_cap, K), -1, dtype=np.int16)
    tbucket = np.zeros((h_cap, K), dtype=np.int8)
    power_counts = np.zeros((N, levels.size - 1), dtype=np.float64)
    H = fn(_ptr(stim_np, cptr), N, K, f_layout,
           _ptr(levels, ctypes.c_float), levels.size, h_cap,
           _ptr(targets, ctypes.c_int16), _ptr(tbucket, ctypes.c_int8),
           _ptr(power_counts, ctypes.c_double))
    if H == -2:
        raise ValueError(_MISMATCH.format(levels[1:].tolist()))
    if H == -1:
        return "overflow"
    if H == 0:
        return None
    return targets[:H], tbucket[:H], power_counts


def _encoder(lib, part, bits):
    """The library's encoder for ``part``'s dtype and layout, or None."""
    if part.ndim != 2 or not part.flags["C_CONTIGUOUS"]:
        return None, None
    if part.dtype == np.float64:
        return getattr(lib, f"cm_encode_traces_int{bits}_f64"), ctypes.c_double
    if part.dtype == np.float32:
        return getattr(lib, f"cm_encode_traces_int{bits}_f32"), ctypes.c_float
    return None, None


def encode_traces_int4(part, decimate=1, out_rows=None):
    """The int4 trace-wire encode of a C-contiguous [B, T] f32/f64 chunk
    in one pass: cast to f32, (mean-pool by ``decimate``), quantise to
    peak/7 codes, pack two a byte (low nibble = even sample). Returns
    ``(packed uint8 [out_rows or B, ceil(T'/2)], scale f32 [B])``, None
    for another layout or dtype. Raises ValueError on a non-finite
    sample or ``out_rows < B``."""
    lib = library()
    fn, cptr = _encoder(lib, part, 4)
    if fn is None:
        return None
    B, T = part.shape
    rows = B if out_rows is None else int(out_rows)
    if rows < B:
        raise ValueError(f"out_rows={rows} smaller than the chunk ({B})")
    t2 = (T // 2 + (T % 2)) if decimate == 2 else T
    packed = np.zeros((rows, (t2 + 1) // 2), dtype=np.uint8)
    scale = np.empty(B, dtype=np.float32)
    if fn(_ptr(part, cptr), B, T, int(decimate),
          _ptr(packed, ctypes.c_uint8), _ptr(scale, ctypes.c_float)) == -1:
        raise ValueError(_NON_FINITE.format("int4 wire format"))
    return packed, scale


def encode_traces_int8(part, out=None):
    """The int8 twin of :func:`encode_traces_int4`: peak/127 codes of a
    C-contiguous [B, T] f32/f64 chunk. ``out`` (C-contiguous int8 [B, T])
    receives the codes in place. Returns ``(codes, scale f32 [B])``, None
    for another layout, dtype or ``out``."""
    lib = library()
    fn, cptr = _encoder(lib, part, 8)
    if fn is None:
        return None
    B, T = part.shape
    if out is None:
        out = np.empty((B, T), dtype=np.int8)
    elif (out.dtype != np.int8 or out.shape != (B, T)
          or not out.flags["C_CONTIGUOUS"]):
        return None
    scale = np.empty(B, dtype=np.float32)
    if fn(_ptr(part, cptr), B, T, 1, _ptr(out, ctypes.c_uint8),
          _ptr(scale, ctypes.c_float)) == -1:
        raise ValueError(_NON_FINITE.format("int8 trace wire"))
    return out, scale


def decode_traces_int4(packed, scale, t_true, decimate=1):
    """The int4/int4d2 wire back to dense f32 [B, t_true] in one pass a
    row: unpack, multiply the scale, (upsample by 2). None unless
    ``packed`` is C-contiguous uint8 [B, ceil(t2/2)] and ``scale`` [B]."""
    lib = library()
    if (packed.ndim != 2 or packed.dtype != np.uint8
            or not packed.flags["C_CONTIGUOUS"]):
        return None
    scale = np.ascontiguousarray(scale, dtype=np.float32)
    B = packed.shape[0]
    t2 = (t_true + 1) // 2 if decimate == 2 else t_true
    if scale.shape != (B,) or packed.shape[1] != (t2 + 1) // 2:
        return None
    out = np.empty((B, t_true), dtype=np.float32)
    lib.cm_decode_traces_int4(
        _ptr(packed, ctypes.c_uint8), B, int(t_true), int(decimate),
        _ptr(scale, ctypes.c_float), _ptr(out, ctypes.c_float))
    return out


# -- the plain (numpy) versions ---------------------------------------------

def extract_windows_plain(timeline, stim_times, pre=100, width=900):
    """numpy version of :func:`extract_windows`."""
    timeline = _as_f32(timeline)
    stim_times = np.ascontiguousarray(stim_times, dtype=np.int64)
    T = timeline.size
    idx = stim_times[:, None] - pre + np.arange(width)[None, :]
    valid = (idx >= 0) & (idx < T)
    return np.where(valid, timeline[np.clip(idx, 0, T - 1)],
                    0.0).astype(np.float32)


def trapz_rows_plain(traces):
    """numpy version of :func:`trapz_rows`: the trapezoids of each row
    summed in order from the first, as the library's loop does (so the
    two agree bit for bit; ``np.trapezoid`` sums pairwise)."""
    x = _as_f32(traces).astype(np.float64)
    terms = 0.5 * (x[:, :-1] + x[:, 1:])
    if terms.shape[1] == 0:
        return np.zeros(x.shape[0])
    return np.cumsum(terms, axis=1)[:, -1]


def extract_windows_with_charge_plain(timeline, stim_times, pre=100,
                                      width=900):
    """numpy version of :func:`extract_windows_with_charge`."""
    windows = extract_windows_plain(timeline, stim_times, pre, width)
    return windows, trapz_rows_plain(windows)


def sparsify_stim_plain(stim_np, levels_np, h_cap):
    """numpy version of :func:`sparsify_stim`."""
    if stim_np.dtype not in (np.float32, np.float64):
        return None
    N, K = stim_np.shape
    if N > 32766:
        return None
    # nonzero() on the transposed mask comes out sorted by column
    nz_k, nz_n = np.nonzero((stim_np != 0).T)
    if nz_k.size == 0:
        return None
    counts = np.bincount(nz_k, minlength=K)
    H = int(counts.max())
    if H > max(int(h_cap), 1):
        return "overflow"
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slots = np.arange(nz_k.size) - offsets[nz_k]
    targets = np.full((H, K), -1, dtype=np.int16)
    tbucket = np.zeros((H, K), dtype=np.int8)
    targets[slots, nz_k] = nz_n.astype(np.int16)
    levels = np.asarray(levels_np, dtype=np.float32)
    # bucket in f32: a mixed f64/f32 searchsorted mis-buckets powers
    # that float32 cannot represent
    vals32 = stim_np[nz_n, nz_k].astype(np.float32)
    buckets = np.searchsorted(levels, vals32)
    safe = np.minimum(buckets, levels.size - 1)
    if not np.array_equal(levels[safe], vals32):
        raise ValueError(_MISMATCH.format(levels[1:].tolist()))
    buckets = buckets.astype(np.int8)
    tbucket[slots, nz_k] = buckets
    power_counts = np.zeros((N, levels.size - 1))
    np.add.at(power_counts, (nz_n, buckets.astype(np.int64) - 1), 1.0)
    return targets, tbucket, power_counts


def encode_traces_int4_plain(part, decimate=1, out_rows=None):
    """numpy version of :func:`encode_traces_int4` (any [B, T] chunk)."""
    from .quant import _pool2, quantise_pack_int4

    src = np.asarray(part, dtype=np.float32)
    if decimate == 2:
        src = _pool2(src)
    if out_rows is not None and int(out_rows) < src.shape[0]:
        raise ValueError(
            f"out_rows={out_rows} smaller than the chunk ({src.shape[0]})")
    return quantise_pack_int4(src, out_rows=out_rows)


def encode_traces_int8_plain(part, out=None):
    """numpy version of :func:`encode_traces_int8` (any [..., T] block)."""
    part = np.asarray(part, dtype=np.float32)
    scale = (np.abs(part).max(axis=-1) / np.float32(127.0)).astype(
        np.float32)
    if not np.isfinite(scale).all():
        raise ValueError(_NON_FINITE.format("int8 trace wire"))
    scale = np.where(scale > 0, scale, np.float32(1.0))
    if out is None:
        out = np.empty(part.shape, dtype=np.int8)
    np.rint(part / scale[..., None], out=out, casting="unsafe")
    return out, scale


def decode_traces_int4_plain(packed, scale, t_true, decimate=1):
    """numpy version of :func:`decode_traces_int4`: unpack, multiply the
    per-trace scale and, for ``decimate=2``, upsample (the device
    unpack's arithmetic)."""
    from .quant import _upsample2, unpack_int4_codes

    th = (t_true + 1) // 2 if decimate == 2 else t_true
    traces = unpack_int4_codes(packed, th).astype(np.float32)
    traces = traces * np.asarray(scale, dtype=np.float32)[:, None]
    if decimate == 2:
        traces = _upsample2(traces, t_true)
    return traces
