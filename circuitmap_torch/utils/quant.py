"""Host-side trace-wire codecs (port of ``circuitmap_tpu/utils/quant.py``):
per-trace peak int8 and int4 codes, the 2x mean-pool of the int4d2 wire
and its linear upsample, the host decode and the ``PackedInt4Traces``
container of an int4 body, plus the torch unpack that runs on the
device.

The encoders and the host decode run in the host library
(``utils/native.py``, one threaded pass over the source), as the JAX
package's do; its numpy versions are ``native.*_plain``. Quantisation
always happens in float32 whatever the input dtype, so the codes are
bit-identical to the JAX package's (and to the QAT trainer's train-time
transform).
"""

from __future__ import annotations

import numpy as np
import torch

from . import native


def _native_layout(part):
    """``part`` as the host library reads it: C-contiguous, float32 or
    float64 (every other dtype is cast to float32 first, which is what
    the encoders do to each sample anyway)."""
    dtype = part.dtype if part.dtype in (np.float32, np.float64) \
        else np.float32
    return np.ascontiguousarray(part, dtype=dtype)


def _pool2(x):
    """Antialias mean-pool by 2 on the last axis; an odd tail keeps the
    raw last sample."""
    T = x.shape[-1]
    T2 = T // 2
    p = 0.5 * (x[..., : 2 * T2 : 2] + x[..., 1 : 2 * T2 : 2])
    if T % 2:
        p = np.concatenate([p, x[..., -1:]], axis=-1)
    return p


def _upsample2(p, t_true):
    """Linear upsample by 2 (numpy or torch): even sample
    ``0.75*p[i] + 0.25*p[i-1]``, odd ``0.75*p[i] + 0.25*p[i+1]``, with
    clamped edges, trimmed to ``t_true``."""
    cat = torch.cat if isinstance(p, torch.Tensor) else np.concatenate
    stack = torch.stack if isinstance(p, torch.Tensor) else np.stack
    prev = cat([p[..., :1], p[..., :-1]], -1)
    nxt = cat([p[..., 1:], p[..., -1:]], -1)
    even = 0.75 * p + 0.25 * prev
    odd = 0.75 * p + 0.25 * nxt
    up = stack([even, odd], -1).reshape(*p.shape[:-1], -1)
    return up[..., :t_true]


def quantise_pack_int4(src, out_rows=None):
    """int4 quantise + nibble-pack of a float32 [B, tw] block.

    Returns (packed uint8 [out_rows, ceil(tw/2)], scale f32 [B]); the
    scale is the per-trace step peak/7 (1.0 for all-zero traces), low
    nibble = even sample. Raises on non-finite samples.
    """
    if src.dtype != np.float32:
        raise TypeError("the int4 wire quantises in float32")
    B, tw = src.shape
    rows = B if out_rows is None else int(out_rows)
    scale = (np.abs(src).max(axis=1) / 7.0).astype(np.float32)
    if not np.isfinite(scale).all():
        raise ValueError(
            "traces contain non-finite samples (or peaks above float32 "
            "range); the int4 wire format requires finite traces")
    scale = np.where(scale > 0, scale, np.float32(1.0))
    t_pad = -(-tw // 2) * 2
    q = np.zeros((rows, t_pad), dtype=np.int8)
    np.rint(src / scale[:, None], out=q[:B, :tw], casting="unsafe")
    np.clip(q, -7, 7, out=q)
    qu = q.view(np.uint8)
    packed = (qu[:, 0::2] & 0x0F) | ((qu[:, 1::2] & 0x0F) << 4)
    return packed, scale


def encode_int4_traces(part, decimate=1, out_rows=None):
    """The int4 wire of a [B, T] chunk in its source dtype: cast to f32
    -> (mean-pool by ``decimate``) -> int4 pack, in the host library
    (``native.encode_traces_int4``). Returns (packed uint8 [out_rows or
    B, ceil(T'/2)], scale f32 [B])."""
    part = np.asarray(part)
    if part.ndim != 2:
        raise ValueError(f"expected a [B, T] chunk, got {part.shape}")
    if decimate not in (1, 2):
        raise ValueError(f"decimate must be 1 or 2, got {decimate!r}")
    return native.encode_traces_int4(_native_layout(part), decimate,
                                     out_rows)


def unpack_int4_codes(packed, n_codes):
    """Inverse of the pack (numpy array or torch tensor): two
    sign-extended 4-bit codes per byte, low nibble first, trimmed to
    ``n_codes`` per row."""
    if isinstance(packed, torch.Tensor):
        w = packed.to(torch.int32)
        stack = torch.stack
    else:
        w = np.asarray(packed).astype(np.int32)
        stack = np.stack
    low = w & 0xF
    high = (w >> 4) & 0xF
    # sign-extend: codes 8..15 are -8..-1 (bit 3 set)
    low = low - ((low >> 3) << 4)
    high = high - ((high >> 3) << 4)
    return stack([low, high], -1).reshape(w.shape[0], -1)[:, :n_codes]


def decode_int4_traces(packed, scale, t_true, decimate=1):
    """Dense float32 [rows, t_true] reconstruction of an int4/int4d2
    trace wire on the host: unpack, multiply the per-trace scale and,
    for ``decimate=2``, upsample back to ``t_true``, in the host library
    (``native.decode_traces_int4``). The same arithmetic as the device
    unpack (``solvers/_common.unpack_int4_traces``). Bytes past the
    codes a row needs are ignored."""
    packed = np.asarray(packed)
    t_true = int(t_true)
    t2 = (t_true + 1) // 2 if decimate == 2 else t_true
    width = (t2 + 1) // 2
    if packed.ndim != 2 or packed.shape[1] < width:
        raise ValueError(f"packed must be [rows, >= {width}] for "
                         f"t_true={t_true}, decimate={decimate}; got "
                         f"{packed.shape}")
    packed = np.ascontiguousarray(packed[:, :width]).astype(np.uint8,
                                                            copy=False)
    out = native.decode_traces_int4(packed, scale, t_true, decimate)
    if out is None:
        raise ValueError(f"scale must be [rows={packed.shape[0]}], got "
                         f"{np.shape(scale)}")
    return out


class PackedInt4Traces:
    """A [K, T] trace block held in its int4/int4d2 wire form.

    The fit server receives quantised trace bodies (``psc_q4*`` keys)
    whose codes are exactly what the device wire would derive again from
    their dense reconstruction (the per-row peak code is 7). The wire's
    consumers (``NeuralDemixer.__call__``, ``_common.prepare_traces``,
    the ``*_many`` upload) ship the codes to the device as they are;
    every other consumer gets the dense reconstruction through
    ``__array__`` (memoised).

    ``packed``: uint8 [rows, ceil(t2/2)] nibble pairs (t2 = code count:
    ceil(T/2) for ``decimate=2``, else T); ``scale``: float32 [rows];
    ``t_true``: T of the reconstructed traces; ``lead``: the logical
    leading dims, ``(rows,)`` for a [K, T] block or ``(B, K)`` for a
    ``/fit_many`` batch (``flat()`` is the [rows, T] view).
    """

    __slots__ = ("packed", "scale", "t_true", "decimate", "lead",
                 "_dense")

    def __init__(self, packed, scale, t_true, decimate=1, lead=None):
        packed = np.asarray(packed)
        scale = np.asarray(scale, dtype=np.float32)
        t_true = int(t_true)
        if decimate not in (1, 2):
            raise ValueError(f"decimate must be 1 or 2, got {decimate!r}")
        t2 = (t_true + 1) // 2 if decimate == 2 else t_true
        if (packed.ndim != 2 or packed.dtype != np.uint8
                or t_true <= 0 or packed.shape[1] != (t2 + 1) // 2):
            raise ValueError(
                f"packed must be uint8 [rows, {(t2 + 1) // 2}] for "
                f"t_true={t_true}, decimate={decimate}; got "
                f"{packed.dtype} {packed.shape}")
        if scale.shape != (packed.shape[0],):
            raise ValueError(
                f"scale must be [rows={packed.shape[0]}], got "
                f"{scale.shape}")
        lead = (packed.shape[0],) if lead is None \
            else tuple(int(d) for d in lead)
        if (not lead or any(d <= 0 for d in lead)
                or int(np.prod(lead, dtype=np.int64)) != packed.shape[0]):
            raise ValueError(
                f"lead={lead} does not match {packed.shape[0]} "
                "packed rows")
        self.packed = packed
        self.scale = scale
        self.t_true = t_true
        self.decimate = decimate
        self.lead = lead
        # one slot shared with flat() views: a dense() on either fills it
        self._dense = [None]

    @property
    def shape(self):
        return (*self.lead, self.t_true)

    @property
    def ndim(self):
        return len(self.lead) + 1

    def __len__(self):
        return self.lead[0]

    def flat(self):
        """The [rows, T] view of the same codes (shared buffers and
        dense memo)."""
        if len(self.lead) == 1:
            return self
        out = PackedInt4Traces(self.packed, self.scale, self.t_true,
                               self.decimate)
        out._dense = self._dense
        return out

    def rows(self, lo, hi):
        """The [hi - lo, T] block of rows ``lo:hi`` of the flat view."""
        return PackedInt4Traces(self.packed[lo:hi], self.scale[lo:hi],
                                self.t_true, self.decimate)

    def dense(self):
        """Dense float32 [*lead, T] reconstruction (memoised)."""
        if self._dense[0] is None:
            self._dense[0] = decode_int4_traces(
                self.packed, self.scale, self.t_true, self.decimate)
        if len(self.lead) == 1:
            return self._dense[0]
        return self._dense[0].reshape(*self.lead, self.t_true)

    def __array__(self, dtype=None, copy=None):
        d = self.dense()
        if dtype is not None and np.dtype(dtype) != d.dtype:
            return d.astype(dtype)
        if copy:
            return d.copy()
        return d


def quantise_int8(part, out=None):
    """Per-trace peak/127 int8 codes for a [..., T] block, in f32, in
    the host library (``native.encode_traces_int8`` on the [rows, T]
    view).

    Returns ``(codes int8 [..., T], scale f32 [...])`` (scale 1.0 for
    all-zero rows); ``out`` (C-contiguous int8 [..., T]) optionally
    receives the codes. Raises on non-finite input.
    """
    part = _native_layout(np.asarray(part))
    lead, t = part.shape[:-1], part.shape[-1]
    flat_out = None
    if out is not None:
        if (out.dtype != np.int8 or out.shape != part.shape
                or not out.flags["C_CONTIGUOUS"]):
            raise ValueError(
                f"out must be C-contiguous int8 {part.shape}, got "
                f"{out.dtype} {out.shape}")
        flat_out = out.reshape(-1, t)
    codes, scale = native.encode_traces_int8(part.reshape(-1, t),
                                             out=flat_out)
    return (out if out is not None else codes.reshape(part.shape),
            scale.reshape(lead))
