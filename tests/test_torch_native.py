"""The port's host library (``circuitmap_torch/utils/native.py``) against
the JAX package's (``circuitmap_tpu/utils/native.py``, built here with
g++) and against its own numpy versions (``native.*_plain``), bit for
bit, for every function; the call sites that route through it; and a
build that fails raising instead of falling back to numpy.

The cases are those of ``tests/test_native.py``: dtype x decimate x odd
T, ``out_rows`` padding, int8 in place, the non-finite raise, Fortran
layout, float32 input and "overflow", edge padding and stim times far
out of range. Thread counts: the library runs a row (or a column block)
per task, so a block encoded whole (many workers) must equal the same
rows encoded in chunks too small to be split (one worker).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from circuitmap_tpu.solvers import _common as jcommon
from circuitmap_tpu.utils import io as jio
from circuitmap_tpu.utils import native as jn
from circuitmap_tpu.utils import quant as jquant
from circuitmap_torch.solvers import _common
from circuitmap_torch.utils import io as tio
from circuitmap_torch.utils import native
from circuitmap_torch.utils import quant

REPO = Path(__file__).resolve().parent.parent
LEVELS = np.asarray([0.0, 45.0, 55.0, 65.0], np.float32)


def _same(a, b):
    """Equal bit for bit: arrays, tuples of arrays, None or a string."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert isinstance(a, tuple) and isinstance(b, tuple)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(np.ascontiguousarray(a).reshape(-1).view(np.uint8),
                              np.ascontiguousarray(b).reshape(-1).view(np.uint8))
        return
    assert a == b


def _traces(B=64, T=900, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T)) * rng.gamma(2.0, 40.0, size=(B, 1))
    if B >= 6 and T >= 8:
        x[:4] = 0.0  # all-zero rows take the scale=1 branch
        # exact .5-boundary code values: peak 7 -> scale 0.25
        x[5, :8] = [7.0, 1.125, -1.125, 0.625, -0.625, 0.375, 3.625, 0]
    return np.ascontiguousarray(x.astype(dtype))


def _stim(N=137, K=700, H=6, seed=0):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    for k in range(3, K):
        tgt = rng.choice(N, size=rng.integers(1, H + 1), replace=False)
        stim[tgt, k] = rng.choice([45.0, 55.0, 65.0])
    return stim


@pytest.fixture(scope="module")
def timeline():
    return np.random.default_rng(0).normal(size=200_000).astype(np.float32)


def test_builds_and_loads():
    assert native.native_available()
    assert jn.native_available()
    lib = native.library()
    assert lib is native.library()  # loaded once
    assert native.library_path().exists()


# -- trace-wire encoders ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("decimate", [1, 2])
@pytest.mark.parametrize("T", [900, 901])
def test_int4_encode_matches_jax_and_plain(dtype, decimate, T):
    part = _traces(T=T, dtype=dtype)
    got = native.encode_traces_int4(part, decimate=decimate)
    _same(got, jn.encode_traces_int4(part, decimate=decimate))
    _same(got, native.encode_traces_int4_plain(part, decimate=decimate))
    assert got[0].dtype == np.uint8 and got[1].dtype == np.float32


def test_int4_out_rows_padding():
    part = _traces(B=13, T=640)
    got = native.encode_traces_int4(part, decimate=2, out_rows=16)
    _same(got, jn.encode_traces_int4(part, decimate=2, out_rows=16))
    _same(got, native.encode_traces_int4_plain(part, 2, out_rows=16))
    assert np.all(got[0][13:] == 0)
    for fn in (native.encode_traces_int4, native.encode_traces_int4_plain):
        with pytest.raises(ValueError):
            fn(part, out_rows=8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_int8_encode_matches_jax_and_plain(dtype):
    part = _traces(T=777, dtype=dtype)
    got = native.encode_traces_int8(part)
    _same(got, jn.encode_traces_int8(part))
    _same(got, native.encode_traces_int8_plain(part))


def test_int8_out_in_place():
    part = _traces(B=8, T=200)
    buf = np.zeros((8, 200), dtype=np.int8)
    codes, scale = native.encode_traces_int8(part, out=buf)
    assert codes is buf
    _same((buf, scale), jn.encode_traces_int8(part))
    # an out the library cannot write is refused, as the JAX module does
    assert native.encode_traces_int8(part, out=buf[:, :100]) is None
    # quant.quantise_int8 writes a padded buffer's leading rows in place
    big = np.full((10, 200), 5, dtype=np.int8)
    q, s = quant.quantise_int8(part, out=big[:8])
    assert q.base is big and np.array_equal(big[:8], buf)
    assert np.all(big[8:] == 5)
    with pytest.raises(ValueError, match="out must be"):
        quant.quantise_int8(part, out=np.zeros((8, 200), np.int16))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf, 1e200])
def test_non_finite_raises(bad):
    part = _traces(B=8, T=64)
    part[3, 10] = bad
    for fn in (native.encode_traces_int4, native.encode_traces_int8,
               native.encode_traces_int4_plain,
               native.encode_traces_int8_plain, quant.encode_int4_traces,
               quant.quantise_int8):
        with pytest.raises(ValueError, match="non-finite"):
            fn(part)


def test_other_layouts_are_refused_as_in_jax():
    base = _traces(B=16, T=300)
    view = base[::2]
    assert not view.flags["C_CONTIGUOUS"]
    for mod in (native, jn):
        assert mod.encode_traces_int4(view) is None
        assert mod.encode_traces_int8(view) is None
        assert mod.encode_traces_int4(base.astype(np.float16)) is None
        assert mod.encode_traces_int4(base[0]) is None
        packed, scale = mod.encode_traces_int4(base)
        assert mod.decode_traces_int4(packed[::2], scale[::2], 300) is None
        assert mod.decode_traces_int4(packed, scale[:3], 300) is None
        assert mod.decode_traces_int4(packed, scale, 299, 2) is None


@pytest.mark.parametrize("decimate", [1, 2])
@pytest.mark.parametrize("T", [900, 901])
def test_int4_decode_matches_jax_and_plain(decimate, T):
    part = _traces(B=48, T=T, dtype=np.float32)
    packed, scale = native.encode_traces_int4(part, decimate=decimate)
    got = native.decode_traces_int4(packed, scale, T, decimate)
    _same(got, jn.decode_traces_int4(packed, scale, T, decimate))
    _same(got, native.decode_traces_int4_plain(packed, scale, T, decimate))
    assert got.dtype == np.float32


def test_thread_count_does_not_change_the_codes():
    """A 2,000-row block takes every core; 8-row chunks take one worker
    each (the library splits below 32 rows into one task)."""
    part = _traces(B=2000, T=901)
    whole = native.encode_traces_int4(part, decimate=2)
    chunks = [native.encode_traces_int4(part[i:i + 8], decimate=2)
              for i in range(0, 2000, 8)]
    _same(whole, tuple(np.concatenate(c) for c in zip(*chunks)))
    whole8 = native.encode_traces_int8(part)
    chunks8 = [native.encode_traces_int8(part[i:i + 8])
               for i in range(0, 2000, 8)]
    _same(whole8, tuple(np.concatenate(c) for c in zip(*chunks8)))
    dec = native.decode_traces_int4(*whole, 901, 2)
    dec_chunks = [native.decode_traces_int4(whole[0][i:i + 8],
                                            whole[1][i:i + 8], 901, 2)
                  for i in range(0, 2000, 8)]
    _same(dec, np.concatenate(dec_chunks))


# -- the routed call sites --------------------------------------------------

@pytest.mark.parametrize("decimate", [1, 2])
def test_quant_routes_match_jax(decimate):
    part = _traces(B=32, T=901)
    got = quant.encode_int4_traces(part, decimate=decimate)
    _same(got, jquant.encode_int4_traces(part, decimate=decimate))
    _same(quant.decode_int4_traces(*got, 901, decimate),
          jquant.decode_int4_traces(*got, 901, decimate))
    # a strided view and a float16 block take the library too: the same
    # codes as their float32 C-ordered copies
    view = part[::2]
    _same(quant.encode_int4_traces(view, decimate=decimate),
          jquant.encode_int4_traces(view, decimate=decimate))
    half = part.astype(np.float16)
    _same(quant.encode_int4_traces(half, decimate=decimate),
          native.encode_traces_int4_plain(half, decimate=decimate))
    # bytes past the codes a row needs are ignored
    wide = np.concatenate([got[0], np.full((32, 3), 0x77, np.uint8)], 1)
    _same(quant.decode_int4_traces(wide, got[1], 901, decimate),
          native.decode_traces_int4_plain(wide, got[1], 901, decimate))


def test_quantise_int8_routes_match_jax():
    part = _traces(B=12, T=333)
    _same(quant.quantise_int8(part), jquant.quantise_int8(part))
    block = part.reshape(3, 4, 333)  # [..., K, T]: the JAX numpy route
    _same(quant.quantise_int8(block), jquant.quantise_int8(block))
    _same(quant.quantise_int8(part[0]), jquant.quantise_int8(part[0]))


def test_call_sites_route_through_the_library(monkeypatch):
    """Each of the four host steps calls the library once."""
    calls = []
    for name in ("sparsify_stim", "encode_traces_int4", "encode_traces_int8",
                 "decode_traces_int4", "extract_windows",
                 "extract_windows_with_charge"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    part = _traces(B=8, T=100)
    quant.encode_int4_traces(part, decimate=2)
    quant.quantise_int8(part)
    quant.decode_int4_traces(*quant.encode_int4_traces(part), 100)
    _common._sparsify(_stim(N=64, K=300, H=4), LEVELS)
    tio.window_continuous_recording(part.ravel(), [50], 10, 20)
    tio.window_continuous_recording(part.ravel(), [50], 10, 20, True)
    assert calls == ["encode_traces_int4", "encode_traces_int8",
                     "encode_traces_int4", "decode_traces_int4",
                     "sparsify_stim", "extract_windows",
                     "extract_windows_with_charge"]


# -- windowing --------------------------------------------------------------

def test_windows_match_jax_and_plain(timeline):
    rng = np.random.default_rng(1)
    times = np.sort(rng.integers(1000, 190_000, size=300)).astype(np.int64)
    got = native.extract_windows(timeline, times, pre=100, width=900)
    _same(got, jn.extract_windows(timeline, times, pre=100, width=900))
    _same(got, native.extract_windows_plain(timeline, times, 100, 900))
    fused = native.extract_windows_with_charge(timeline, times)
    _same(fused, jn.extract_windows_with_charge(timeline, times))
    _same(fused[0], got)
    _same(native.trapz_rows(got), jn.trapz_rows(got))
    _same(native.trapz_rows(got), native.trapz_rows_plain(got))
    _same(fused, native.extract_windows_with_charge_plain(timeline, times))
    # and np.trapezoid's pairwise sum agrees to rounding
    np.testing.assert_allclose(fused[1], np.trapezoid(
        got.astype(np.float64), axis=-1), rtol=1e-12, atol=1e-9)
    _same(native.trapz_rows(got[:, :1]), native.trapz_rows_plain(got[:, :1]))


def test_edge_padding(timeline):
    times = np.array([10, len(timeline) - 10], dtype=np.int64)
    w = native.extract_windows(timeline, times, pre=100, width=900)
    _same(w, native.extract_windows_plain(timeline, times, 100, 900))
    assert np.all(w[0, :90] == 0.0)
    np.testing.assert_array_equal(w[0, 90:], timeline[:810])
    assert np.all(w[1, -(900 - 110):] == 0.0)


def test_far_out_of_range_stim_times(timeline):
    times = np.array([-1500, len(timeline) + 1500], dtype=np.int64)
    w = native.extract_windows(timeline, times, pre=100, width=900)
    assert np.all(w == 0.0)
    w2, c = native.extract_windows_with_charge(timeline, times)
    assert np.all(w2 == 0.0) and np.all(c == 0.0)
    _same((w2, c), jn.extract_windows_with_charge(timeline, times))


def test_window_continuous_recording_equals_jax(timeline):
    times = np.array([0, 50, 2000, 199_950])
    for with_charge in (False, True):
        _same(tio.window_continuous_recording(timeline, times, 100, 200,
                                              with_charge),
              jio.window_continuous_recording(timeline, times, 100, 200,
                                              with_charge))


# -- the stim sparsify ------------------------------------------------------

@pytest.mark.parametrize("layout", ["C", "F"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sparsify_matches_jax_and_plain(layout, dtype):
    stim = np.asarray(_stim(), dtype=dtype, order=layout)
    got = native.sparsify_stim(stim, LEVELS, h_cap=17)
    _same(got, jn.sparsify_stim(stim, LEVELS, h_cap=17))
    _same(got, native.sparsify_stim_plain(stim, LEVELS, 17))
    assert got[0].dtype == np.int16 and got[1].dtype == np.int8


def test_sparsify_fortran_f32_overflow_and_mismatch():
    """Both layouts and both dtypes give one payload (simulate() returns
    its design Fortran-ordered as float64, a loaded .mat is float32);
    overflow and a level mismatch report alike from every route."""
    stim_c = np.ascontiguousarray(_stim(N=64, K=300, H=4, seed=2))
    want = native.sparsify_stim(stim_c, LEVELS, h_cap=8)
    for other in (np.asfortranarray(stim_c), stim_c.astype(np.float32),
                  np.asfortranarray(stim_c.astype(np.float32))):
        _same(native.sparsify_stim(other, LEVELS, h_cap=8), want)
        for fn in (native.sparsify_stim, jn.sparsify_stim,
                   native.sparsify_stim_plain):
            assert fn(other, LEVELS, 1) == "overflow"
        bad = other.copy(order="K")
        bad[3, 7] = 99.0
        for fn in (native.sparsify_stim, jn.sparsify_stim,
                   native.sparsify_stim_plain):
            with pytest.raises(ValueError, match="not covered"):
                fn(bad, LEVELS, 8)
    for fn in (native.sparsify_stim, jn.sparsify_stim,
               native.sparsify_stim_plain):
        assert fn(np.zeros((8, 16)), LEVELS, 4) is None
        assert fn(stim_c.astype(np.int32), LEVELS, 8) is None
    # a strided view is read through a C-ordered copy
    _same(native.sparsify_stim(stim_c[:, ::2], LEVELS, 8),
          jn.sparsify_stim(stim_c[:, ::2], LEVELS, 8))


def test_sparsify_int16_targets_and_column_split():
    """Neuron indices up to 32,766 survive the int16 targets, N above it
    is refused, and one worker a column block gives the payload of the
    whole stim taken in column blocks below the library's split."""
    N, K = 32_766, 1536
    rng = np.random.default_rng(4)
    stim = np.zeros((N, K), np.float32)
    cols = np.repeat(np.arange(K), 3)
    rows = np.concatenate([[N - 1, N - 2, 0],
                           rng.integers(0, N, 3 * K - 3)])
    stim[rows, cols] = rng.choice([45.0, 55.0, 65.0], 3 * K)
    got = native.sparsify_stim(stim, LEVELS, 96)
    _same(got, jn.sparsify_stim(stim, LEVELS, 96))
    assert got[0].max() == N - 1
    parts = [native.sparsify_stim(stim[:, k:k + 512], LEVELS, 96)
             for k in range(0, K, 512)]
    H = got[0].shape[0]
    pad = [np.pad(p[0], ((0, H - p[0].shape[0]), (0, 0)),
                  constant_values=-1) for p in parts]
    _same(got[0], np.concatenate(pad, axis=1))
    _same(got[2], sum(p[2] for p in parts))
    del stim
    wide = np.zeros((N + 1, 4), np.float32)
    assert native.sparsify_stim(wide, LEVELS, 8) is None


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64])
def test_common_sparsify_equals_jax(dtype):
    stim = _stim(N=90, K=400, H=5, seed=5).astype(dtype)
    levels = np.asarray([0.0, 45.0, 55.0, 65.0], np.float32)
    _same(_common._sparsify(stim, levels), jcommon._sparsify(stim, levels))
    dense = _stim(N=8, K=50, H=6, seed=6)
    assert _common._sparsify(dense, levels) is None  # too dense: overflow
    assert jcommon._sparsify(dense, levels) is None
    assert _common._upload_plan(dense, None)[2] == "bucket"


# -- no fallback ------------------------------------------------------------

_BROKEN_BUILD = r"""
import sys
from circuitmap_torch.utils import native
native.COMPILER = "/nonexistent/g++"
assert not native.native_available()
try:
    native.encode_traces_int4(__import__("numpy").zeros((2, 8)))
except RuntimeError as exc:
    print("RAISED", "g++" in str(exc) and "install" in str(exc))
else:
    print("FELL BACK")
"""


def test_a_failed_build_raises_and_does_not_fall_back(tmp_path):
    """A compiler that is missing (another source hash's library is
    absent from an empty build directory) raises RuntimeError with a
    hint, from every function; nothing answers from numpy."""
    import os

    env = dict(os.environ, CIRCUITMAP_TORCH_BUILD_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _BROKEN_BUILD], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["RAISED", "True"]
    assert list(tmp_path.glob("*.so")) == []


def test_a_compiler_error_carries_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CIRCUITMAP_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed to build") as info:
        native.sparsify_stim(np.ones((2, 2)), LEVELS, 2)
    assert "broken.cpp" in str(info.value)
    assert not list((tmp_path / "b").glob("*.so"))
