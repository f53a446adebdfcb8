"""Shared host->device preamble for the solvers (port of the numpy paths
of ``circuitmap_tpu/solvers/_common.py``).

Traces go up in a choice of wires (``prepare_traces``). The [N, K]
stimulus matrix goes up in hologram form when it is column-sparse (each
trial stimulates at most H of N neurons: [H, K] target indices plus
[H, K] power buckets), else as int8 power-bucket indices, else dense,
and is rebuilt on the device.

Precision contract (as in the JAX package): the device stimulus holds
float32 level values, while the host powers returned to callers keep
the stim matrix's own precision. ``powers_np`` is for host comparisons
against the original stim, ``powers_dev_np`` for any device powers
array.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._device import torch_dtype
from ..utils import native
from ..utils.profiling import span
from ..utils.quant import (PackedInt4Traces, _upsample2, encode_int4_traces,
                           quantise_int8, unpack_int4_codes)


# The single-card working-set ceiling of a fit, in float32 elements of
# one [rows, K] array: the largest N x K that fit on one NVIDIA H100 80GB
# HBM3 (700.00 W) in the ladder of MEMORY_CLIFF_H100.json (``python -m
# circuitmap_torch memory-cliff``: caviar, 2 iterations; N=32,000 at
# K=106,250 fit with a 72.52 GB peak, K=112,500 ran out). No lane
# padding: the TPU's 128-lane layout does not apply.
_SINGLE_CARD_ELEM_CLIFF = 32000 * 106250


class MemoryEnvelopeWarning(ResourceWarning):
    """Single-card memory-envelope preflight (warn_single_chip_envelope).

    Subclasses ResourceWarning for its meaning, but is shown always (the
    filter below): CPython's default filters ignore ResourceWarning,
    which would silence the preflight in the plain ``python script.py``
    runs it exists for."""


warnings.simplefilter("always", MemoryEnvelopeWarning)


def warn_single_chip_envelope(n_rows, k, what="this fit", dtype=None,
                              device=None):
    """Warn before a single-card fit whose [n_rows, k] working arrays
    pass the envelope measured on the H100 (MEMORY_CLIFF_H100.json), so
    that it can go to the sharded path instead of ending in a CUDA
    out-of-memory error. The cliff is a byte budget measured with
    float32 arrays: a wider dtype scales the element count by
    itemsize/4 (float64 reaches it at half the elements). Advisory,
    not an error. Silent when ``device`` is the CPU (host memory bounds
    those); ``None`` means the GPU, as at every entry point. Nothing is
    allocated. Single-card entries call it; the sharded and distributed
    paths, whose per-device share is the point, do not."""
    if torch.device("cuda" if device is None else device).type == "cpu":
        return
    itemsize = 4 if dtype is None else torch_dtype(dtype).itemsize
    elems = int(n_rows) * int(k) * itemsize // 4  # float32-equivalent
    if elems > _SINGLE_CARD_ELEM_CLIFF:
        warnings.warn(
            f"{what} allocates [{n_rows}, {k}] working arrays "
            f"({elems:.2e} float32-equivalent elements), past the "
            f"~{_SINGLE_CARD_ELEM_CLIFF:.1e}-element single-card envelope "
            "measured on an 80 GB H100 (MEMORY_CLIFF_H100.json): expect "
            "CUDA out-of-memory. Shard the trials over a mesh instead: "
            "parallel.caviar_sharded(mesh=...) on one host, or "
            "parallel.distributed.* across processes.",
            MemoryEnvelopeWarning, stacklevel=3)


class DataThinDesignWarning(UserWarning):
    """Design-identifiability preflight (warn_data_thin_design)."""


# identifiability floor in mean stimulations per neuron, armed from
# N >= 2000 (the JAX package's scaling study, SCALING.md; a property of
# the design, not of the hardware)
_DATA_THIN_STIMS_PER_NEURON = 100.0
_DATA_THIN_MIN_N = 2000


def warn_data_thin_design(power_counts_np, k, what="this fit"):
    """Warn when the mean per-neuron stimulation count is under the
    ~100-stim identifiability floor (large maps only). ``None`` counts
    (a dense upload) skip the check."""
    if power_counts_np is None:
        return
    per_neuron = np.asarray(power_counts_np).sum(axis=1)
    if per_neuron.size < _DATA_THIN_MIN_N:
        return
    _warn_data_thin(float(per_neuron.mean()), per_neuron.size, k, what)


def warn_data_thin_design_dense(stim_np, k_true=None, what="this fit"):
    """The same preflight for the solvers that keep no per-neuron counts
    (CAVI-SnS, MBCS, the sharded fits): one host ``count_nonzero`` pass,
    paid only from N >= 2000. ``k_true``: the real trial count when the
    stim carries padded columns (the message's trial count)."""
    stim_np = np.asarray(stim_np)
    n = stim_np.shape[0]
    if n < _DATA_THIN_MIN_N:
        return
    k = stim_np.shape[1] if k_true is None else k_true
    _warn_data_thin(float(np.count_nonzero(stim_np)) / n, n, k, what)


def _warn_data_thin(mean_stims, n, k, what):
    if mean_stims < _DATA_THIN_STIMS_PER_NEURON:
        warnings.warn(
            f"{what}: the design stimulates each neuron ~{mean_stims:.0f} "
            f"times on average ({n} neurons over {int(k)} trials) — under "
            f"the ~{int(_DATA_THIN_STIMS_PER_NEURON)}-stim identifiability "
            "floor (SCALING.md). Recovery will be bounded by the design, "
            "not the solver: raise the trial count K and/or the "
            "targets-per-trial H.", DataThinDesignWarning, stacklevel=4)


def unpack_int4_traces(packed, scale, t_true, decimate, device):
    """Float32 [rows, t_true] traces on ``device`` from an int4 wire's
    host codes: the packed bytes and scales go up, and the unpack, the
    scale and (``decimate=2``) the linear upsample run there."""
    n_codes = (t_true + 1) // 2 if decimate == 2 else t_true
    codes = unpack_int4_codes(
        torch.from_numpy(np.ascontiguousarray(packed)).to(device), n_codes)
    traces = codes.float() * torch.from_numpy(
        np.ascontiguousarray(scale, dtype=np.float32)).to(device)[:, None]
    if decimate == 2:
        traces = _upsample2(traces, t_true)
    return traces


def prepare_traces(y_psc, dtype, device, trace_wire=None):
    """[K, T] traces as a ``dtype`` tensor on ``device``.

    A tensor passes through (cast and moved). A host array ships in
    ``trace_wire``: None/"f32" exact, "f16" halved, "int8" quartered
    (per-trace peak/127 codes), "int4"/"int4d2" an eighth/sixteenth
    (peak/7 codes; d2 mean-pools by 2 and upsamples on the device).
    float64 fits keep the exact wire and reject every other.

    A ``PackedInt4Traces`` (an int4 body as the fit server receives it)
    ships its codes as they are, whatever ``trace_wire`` says, and is
    unpacked on the device, so it is never decoded on the host; only an
    "int4d2" wire asked of codes that were not pooled densifies and
    encodes again. A float64 fit rejects it.
    """
    if isinstance(y_psc, torch.Tensor):
        return y_psc.to(device=device, dtype=dtype)
    if trace_wire not in (None, "f32", "f16", "int8", "int4", "int4d2"):
        raise ValueError(
            f"trace_wire must be None, 'f32', 'f16', 'int8', 'int4' or "
            f"'int4d2', got {trace_wire!r}")
    if isinstance(y_psc, PackedInt4Traces):
        if dtype.itemsize > 4:
            raise ValueError(
                "int4-wire trace bodies are incompatible with "
                "dtype=float64 fits (the wire already quantised the "
                "traces; parity-oracle fits need the raw float64 block)")
        flat = y_psc.flat()
        if trace_wire == "int4d2" and flat.decimate == 1:
            out = prepare_traces(flat.dense(), dtype, device, trace_wire)
        else:
            out = unpack_int4_traces(flat.packed, flat.scale, flat.t_true,
                                     flat.decimate, device).to(dtype)
        return out.reshape(y_psc.shape)
    if dtype.itemsize > 4:
        if trace_wire is not None:
            raise ValueError(
                "trace_wire is incompatible with dtype=float64 "
                "(parity-oracle fits must keep full mantissa in transit)")
        return torch.as_tensor(np.asarray(y_psc, dtype=np.float64),
                               device=device)
    arr = np.asarray(y_psc)
    if trace_wire == "f16":
        with span("cm.wire.encode"):
            h = torch.from_numpy(np.asarray(arr, dtype=np.float16))
        return h.to(device).to(dtype)
    if trace_wire == "int8":
        with span("cm.wire.encode"):
            q, scale = quantise_int8(arr)
        return (torch.from_numpy(q).to(device).to(dtype)
                * torch.from_numpy(scale).to(device)[:, None].to(dtype))
    if trace_wire in ("int4", "int4d2"):
        dec = 2 if trace_wire == "int4d2" else 1
        with span("cm.wire.encode"):
            packed, scale = encode_int4_traces(arr, decimate=dec)
        return unpack_int4_traces(packed, scale, arr.shape[1], dec,
                                  device).to(dtype)
    return torch.as_tensor(np.asarray(arr, dtype=np.float32),
                           device=device).to(dtype)


def _levels(stim_np, powers=None):
    """Sorted stimulation levels: (powers_host in the stim's precision,
    the 0-prefixed float32 level table the device reconstruction uses).
    ``powers`` (the rig's levels) skips the np.unique scan."""
    cand = np.unique(stim_np if powers is None else np.asarray(powers))
    cand = cand[cand != 0.0]
    if powers is None and cand.size > 1024:
        raise ValueError(
            f"stim matrix contains {cand.size} distinct nonzero "
            "stimulation levels — the power-curve gate needs repeated "
            "trials per level. Pass powers=[...] with the rig's discrete "
            "command levels, or round the stim matrix to its true levels "
            "before fitting")
    lv32, first = np.unique(cand.astype(np.float32), return_index=True)
    powers_host = cand[first]
    levels_np = np.concatenate([[0.0], lv32]).astype(np.float32)
    return powers_host, levels_np


def _power_mismatch_error(levels_np):
    return ValueError(
        "stim contains stimulation values not covered by the supplied "
        f"powers= levels {levels_np[1:].tolist()}; pass the exact set of "
        "power levels used in the experiment (or omit powers= to derive "
        "them from the stim matrix)")


def hologram_cap(N, max_fill=0.125):
    """The most targets a column of an N-neuron stim may hold for the
    hologram form: ``max_fill`` of the neurons, and at most 96 (the
    device rebuild makes one pass over [N, K] per target)."""
    return max(1, min(int(N * max_fill), 96))


def _sparsify(stim_np, levels_np, max_fill=0.125):
    """Column-sparse hologram form (targets int16 [H, K], -1 padded;
    buckets int8 [H, K]; per-neuron counts per power [N, P]), or None
    when dense is cheaper. One threaded pass of the host library
    (``native.sparsify_stim``). Raises when stim holds values the level
    table cannot represent."""
    if stim_np.dtype not in (np.float32, np.float64):
        stim_np = stim_np.astype(np.float64)
    out = native.sparsify_stim(stim_np, levels_np,
                               hologram_cap(stim_np.shape[0], max_fill))
    if isinstance(out, str):  # "overflow": too dense for hologram form
        return None
    return out


def _bucketise_dense(stim_np, levels_np):
    """Dense int8 bucket matrix, validating level coverage."""
    stim32 = stim_np.astype(np.float32, copy=False)
    bucket = np.searchsorted(levels_np, stim32)
    safe = np.minimum(bucket, levels_np.size - 1)
    if not np.array_equal(levels_np[safe], stim32):
        raise _power_mismatch_error(levels_np)
    return bucket.astype(np.int8)


def _upload_plan(stim_np, powers):
    """(powers_host, levels_np, kind, payload); kind is "dense"
    (payload None), "sparse" ((targets, tbucket, power_counts)) or
    "bucket" (the int8 bucket matrix)."""
    powers_host, levels_np = _levels(stim_np, powers)
    if levels_np.size > 127:
        return powers_host, levels_np, "dense", None
    sparse = _sparsify(stim_np, levels_np)
    if sparse is not None:
        return powers_host, levels_np, "sparse", sparse
    return powers_host, levels_np, "bucket", _bucketise_dense(stim_np,
                                                               levels_np)


def _powers_dev(powers_np, levels_np, kind):
    """The powers matching the values present in the DEVICE stim: the
    original table for a dense upload, the f32 levels otherwise."""
    if kind == "dense":
        return powers_np
    return levels_np[1:].astype(np.float64)


def _stim_on_device(stim_np, levels_np, kind, payload, dtype, device):
    """Rebuild the dense [N, K] stim on the device from its upload."""
    if kind == "dense":
        return torch.as_tensor(stim_np, device=device).to(dtype)
    levels = torch.as_tensor(levels_np, device=device).to(dtype)
    if kind == "bucket":
        return levels[torch.from_numpy(payload).to(device).long()]
    targets, tbucket, _ = payload
    t = torch.from_numpy(targets).to(device).long()       # [H, K]
    vals = levels[torch.from_numpy(tbucket).to(device).long()]
    N, K = stim_np.shape
    cols = torch.arange(K, device=device).expand_as(t)
    keep = t >= 0
    stim = torch.zeros((N, K), dtype=dtype, device=device)
    stim[t[keep], cols[keep]] = vals[keep]
    return stim


def stim_upload_plan(stim, powers):
    """The host half of the stim upload: (stim_np, plan), for
    :func:`prepare_stim` and :func:`prepare_stim_and_init`."""
    stim_np = np.asarray(stim)
    return stim_np, _upload_plan(stim_np, powers)


def prepare_stim(stim, dtype, device, plan=None, powers=None):
    """The stim upload without CAVIaR's mask and lam init. Returns
    (stim_dev, stim_np, powers_np, powers_dev_np), as
    :func:`prepare_stim_and_init` does. ``plan``: the stim's
    :func:`stim_upload_plan` (its second element) when already made;
    else ``powers`` (the rig's levels) skips the level scan."""
    stim_np = np.asarray(stim)
    if plan is None:
        plan = _upload_plan(stim_np, powers)
    powers_np, levels_np, kind, payload = plan
    stim_dev = _stim_on_device(stim_np, levels_np, kind, payload, dtype,
                               device)
    return (stim_dev, stim_np, powers_np,
            _powers_dev(powers_np, levels_np, kind))


def prepare_stim_and_init(stim_np, active, dtype, device, plan):
    """Device (stim, lam_mask, lam0) plus the host bookkeeping, from the
    stim and its :func:`stim_upload_plan`.

    lam0 = 0.95 on targeted active trials (reference caviar.py:32-34).
    Returns (stim_dev, lam_mask, lam0, stim_np, powers_np, powers_dev_np,
    power_counts_np); power_counts_np is the host [N, P] count per power
    when the sparse upload computed it for free, else None.
    """
    powers_np, levels_np, kind, payload = plan
    stim_dev = _stim_on_device(stim_np, levels_np, kind, payload, dtype,
                               device)
    lam_mask = active.to(dtype)
    lam0 = (stim_dev > 0).to(dtype) * 0.95 * lam_mask
    power_counts = payload[2] if kind == "sparse" else None
    return (stim_dev, lam_mask, lam0, stim_np, powers_np,
            _powers_dev(powers_np, levels_np, kind), power_counts)
