"""Dataset and result IO (the port's copy of
``circuitmap_tpu/utils/io.py``).

Loaders for the reference's on-disk formats (.mat / .npy / .npz, and
MATLAB v7.3 / HDF5 files through h5py) and exporters for the fitted
state (savemat + npz, the reference's run_circuitmap_main.py:58-63).
``h5py`` and ``scipy.io`` are imported only when a file needs them.
Continuous recordings are memory-mapped and windowed in the host
library (``utils/native.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import native


# HDF5 file signature — what a MATLAB "-v7.3" .mat actually is
# (scipy.io.loadmat rejects those with NotImplementedError, but real
# rigs export them routinely). A file MATLAB itself writes does NOT
# start with the signature: v7.3 files carry a 512-byte text userblock
# ("MATLAB 7.3 MAT-file, Platform: ...") and the HDF5 superblock sits
# at offset 512 — the HDF5 spec allows it at any power-of-two multiple
# of 512, and h5py reads such files transparently. So the probe scans
# the spec's first few legal offsets, not just 0.
_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"
_HDF5_OFFSETS = (0, 512, 1024, 2048, 4096)


def _is_hdf5(path):
    try:
        with open(path, "rb") as fh:
            for off in _HDF5_OFFSETS:
                fh.seek(off)
                if fh.read(len(_HDF5_MAGIC)) == _HDF5_MAGIC:
                    return True
        return False
    except OSError:
        return False


def _reconcile_orientation(psc, stim, trim_trailing=False):
    """Fix transposed layouts so psc is [K, T] and stim is [N, K].

    MATLAB stores arrays column-major, so a v7.3 dataset read through
    h5py arrives transposed relative to the loadmat convention; a file
    written directly by h5py (row-major) does not. Rather than guess
    the writer, reconcile against the one hard invariant the pair must
    satisfy: psc's trial axis (rows) == stim's trial axis (columns).

    ``trim_trailing`` additionally accepts a SMALL trial-count mismatch
    (an interrupted acquisition writes the design for the full protocol
    but traces only up to the stop — trailing partial trials), keeping
    the common prefix. Off by default: a silent truncation on a large
    mismatch would hide a genuinely wrong file pairing, so the error
    path names the knob instead.
    """
    if psc.ndim != 2 or stim.ndim != 2:
        raise ValueError(
            f"expected 2-D psc and stim arrays, got shapes "
            f"{psc.shape} and {stim.shape}")

    # a mismatch counts as "trailing-partial" when it is a sliver of
    # the protocol, not a different experiment
    def _slack(a, b):
        return abs(a - b) <= max(8, min(a, b) // 100)

    exact = [
        ("as stored", psc.shape[0] == stim.shape[1],
         lambda: (psc, stim)),
        ("both transposed (MATLAB layout)",
         psc.shape[1] == stim.shape[0], lambda: (psc.T, stim.T)),
        ("psc transposed", psc.shape[1] == stim.shape[1],
         lambda: (psc.T, stim)),
        ("stim transposed", psc.shape[0] == stim.shape[0],
         lambda: (psc, stim.T)),
    ]
    matches = [(name, fix) for name, ok, fix in exact if ok]
    # shape coincidences (e.g. N == T == 900, where a MATLAB file's
    # transposed layout ALSO satisfies the as-stored check) make the
    # orientation undecidable from shapes alone — refuse rather than
    # silently feed a time axis to the fit as trials
    distinct = {(m[1]()[0].shape, m[1]()[1].shape) for m in matches}
    if len(distinct) > 1:
        raise ValueError(
            f"ambiguous orientation: psc {psc.shape} / stim {stim.shape} "
            f"admit multiple trial-axis readings "
            f"({', '.join(m[0] for m in matches)}); transpose the "
            "arrays to psc [K, T] / stim [N, K] before saving")
    if matches:
        return matches[0][1]()
    near = [
        ("as stored", _slack(psc.shape[0], stim.shape[1]),
         lambda: (psc, stim)),
        ("both transposed (MATLAB layout)",
         _slack(psc.shape[1], stim.shape[0]), lambda: (psc.T, stim.T)),
    ]
    near_matches = [(name, fix) for name, ok, fix in near if ok]
    if len(near_matches) > 1:
        # same refusal discipline as the exact path: two near-common
        # trial counts make the orientation undecidable from shapes —
        # never guess which axis is time
        raise ValueError(
            f"ambiguous orientation: psc {psc.shape} / stim "
            f"{stim.shape} admit multiple near-matching trial-axis "
            f"readings ({', '.join(m[0] for m in near_matches)}); "
            "transpose the arrays to psc [K, T] / stim [N, K] before "
            "saving")
    if len(near_matches) == 1:
        name, fix = near_matches[0]
        p, s = fix()
        if trim_trailing:
            import warnings

            k = min(p.shape[0], s.shape[1])
            warnings.warn(
                f"trial counts differ by {abs(p.shape[0] - s.shape[1])} "
                f"({name}: psc {p.shape[0]} vs stim {s.shape[1]} "
                f"trials) — keeping the common first {k} trials "
                "(trim_trailing=True; trailing partial trials from an "
                "interrupted acquisition)", stacklevel=3)
            return p[:k], s[:, :k]
        raise ValueError(
            f"trial counts differ by {abs(p.shape[0] - s.shape[1])} "
            f"({name}: psc carries {p.shape[0]} trials, stim "
            f"{s.shape[1]}). If the acquisition stopped mid-protocol "
            "(trailing partial trials), pass trim_trailing=True to "
            "keep the common prefix; otherwise check the file pairing.")
    raise ValueError(
        f"cannot reconcile trial axes: psc {psc.shape} vs stim "
        f"{stim.shape} share no common trial count")


def _validate_finite(psc, stim, on_nonfinite):
    """Reject or repair non-finite entries (NaN channels, saturated/inf
    samples — routine in real rig exports) with an actionable message
    instead of letting them propagate as silently-NaN posteriors.

    ``on_nonfinite``: 'raise' (default), 'drop' (remove the offending
    TRIALS from both arrays), or 'zero' (zero the offending samples —
    appropriate for isolated dead-channel samples where dropping whole
    trials would waste good data). A non-finite STIM always raises: a
    design matrix with NaN power levels is corrupt, not noisy.
    """
    if not np.isfinite(stim).all():
        bad = np.argwhere(~np.isfinite(stim))
        raise ValueError(
            f"stimulus matrix contains {len(bad)} non-finite entries "
            f"(first at neuron {bad[0][0]}, trial {bad[0][1]}) — a "
            "design with NaN/inf power levels is corrupt; re-export it")
    finite = np.isfinite(psc)
    if finite.all():
        return psc, stim
    bad_trials = np.flatnonzero(~finite.all(axis=1))
    n_bad = (~finite).sum()
    if on_nonfinite == "drop":
        import warnings

        keep = finite.all(axis=1)
        warnings.warn(
            f"dropping {bad_trials.size} trials with non-finite "
            f"samples (of {psc.shape[0]}; first: trials "
            f"{bad_trials[:5].tolist()})", stacklevel=3)
        return psc[keep], stim[:, keep]
    if on_nonfinite == "zero":
        import warnings

        warnings.warn(
            f"zeroing {int(n_bad)} non-finite samples across "
            f"{bad_trials.size} trials", stacklevel=3)
        return np.where(finite, psc, 0.0), stim
    raise ValueError(
        f"psc contains {int(n_bad)} non-finite samples across "
        f"{bad_trials.size} trials (first: trials "
        f"{bad_trials[:5].tolist()}) — NaN/inf would propagate through "
        "the fit as NaN posteriors. Pass on_nonfinite='drop' to remove "
        "those trials (whole-trial corruption) or 'zero' to zero the "
        "samples (isolated dead-channel values).")


def load_experiment(path, psc_key="psc", stim_key="stimulus_matrix",
                    on_nonfinite="raise", trim_trailing=False):
    """Load (psc [K, T], stim_matrix [N, K]) from .mat/.npy/.npz/.h5.

    Reference contract: scripts/run_circuitmap_main.py:22-32 loads
    ``psc`` + ``stimulus_matrix`` from a .mat or .npy. The format is
    detected by MAGIC BYTES, not extension: MATLAB v7.3 files are HDF5
    containers that scipy's loadmat cannot read, so any .mat (or
    .h5/.hdf5) with the HDF5 signature routes through h5py, with
    orientation reconciled for MATLAB's column-major storage.

    Real-rig quirks are handled explicitly rather than propagated:
    integer traces (int16/uint16 ADC counts) cast to float; non-finite
    samples raise an actionable error by default
    (``on_nonfinite='drop'|'zero'`` repairs — ``_validate_finite``);
    a small psc/stim trial-count mismatch (interrupted acquisition)
    raises naming ``trim_trailing=True``, which keeps the common
    prefix.
    """
    p = str(path)
    if _is_hdf5(p):
        import h5py

        with h5py.File(p, "r") as f:
            for key in (psc_key, stim_key):
                if key not in f:
                    raise KeyError(
                        f"{p!r} has no dataset {key!r}; found: "
                        f"{sorted(f.keys())}")
            psc = np.asarray(f[psc_key], dtype=float)
            stim = np.asarray(f[stim_key], dtype=float)
        psc, stim = _reconcile_orientation(psc, stim,
                                           trim_trailing=trim_trailing)
        return _validate_finite(psc, stim, on_nonfinite)
    if p.endswith(".mat"):
        from scipy.io import loadmat

        f = loadmat(p)
    elif p.endswith(".npy") or p.endswith(".npz"):
        f = np.load(p, allow_pickle=True)
        if p.endswith(".npy"):
            f = f.item()
    else:
        raise ValueError(f"unsupported experiment format: {p}")
    psc = np.asarray(f[psc_key], dtype=float)
    stim = np.asarray(f[stim_key], dtype=float)
    if psc.shape[0] != stim.shape[1]:
        psc, stim = _reconcile_orientation(psc, stim,
                                           trim_trailing=trim_trailing)
    return _validate_finite(psc, stim, on_nonfinite)


def export_state(out_dir, base_name, state, save_mat=True, save_npz=True):
    """Write weights/uncertainty/spikes in the reference's output layout
    (run_circuitmap_main.py:58-63). Returns the written paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"{base_name}_cmap"
    payload = {
        "weights": np.asarray(state["mu"]),
        "weight_uncertainty": np.asarray(state["beta"]),
        "spikes": np.asarray(state["lam"]),
    }
    written = []
    if save_mat:
        from scipy.io import savemat

        savemat(f"{stem}.mat", payload)
        written.append(f"{stem}.mat")
    if save_npz:
        np.savez(str(stem), **payload)
        written.append(f"{stem}.npz")
    return written


def load_continuous_recording(path, dtype="float32"):
    """Memory-map a raw binary continuous recording (one float per sample)."""
    return np.memmap(path, dtype=dtype, mode="r")


def window_continuous_recording(timeline, stim_times, pre=100, width=900,
                                with_charge=False):
    """Slice a continuous recording into [K, width] float32 response
    windows starting ``pre`` samples before each stim time (zero-padded
    at the recording's edges), in the host library's threaded pass
    (``native.extract_windows``). ``with_charge`` also returns each
    window's trapezoidal charge (float64), the solvers' observation, from
    the same pass."""
    if with_charge:
        return native.extract_windows_with_charge(
            np.asarray(timeline), np.asarray(stim_times), pre, width)
    return native.extract_windows(np.asarray(timeline),
                                  np.asarray(stim_times), pre, width)
