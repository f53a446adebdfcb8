"""The U-Net up blocks' epilogue: ReLU, the linear resize and the skip
concat as one CUDA kernel, and its plain PyTorch version.

``relu_resize_cat(h, size, skip)`` is
``torch.cat([F.interpolate(F.relu(h), size, mode="linear",
align_corners=False), skip], 1)`` (no concat when ``skip`` is None), as
one pass of ``csrc/resize.cu`` over the bytes in place of three ATen
kernels and two passes. The resize reads its taps from
``_resize_taps`` (ATen's sample positions) and computes ATen's lerp, so
it agrees with ``F.interpolate`` on the card to the last bit. It
replaces no TPU kernel: the JAX package's resize is an XLA gather and
lerp (``circuitmap_tpu/demix/unet.py::resize_linear``).

Dispatch is the caller's (``demix/unet.py::forward_shards``): the kernel
serves U-Net inference on the card, and the CPU and training with
autograd recording keep ATen's ops. The wrapper takes CUDA float32,
float64, bfloat16 and float16 tensors and raises on anything else, a
CPU tensor included; the 16-bit types compute in float, as ATen's
kernel does. A row's lines are staged in shared memory when they fit
``SMEM_BYTES`` (12,288 float32 samples a line; a 900-sample trace's
longest is 804); a longer line is read from ``h`` by one block a
channel. ``relu_resize_cat_torch`` computes the kernel's arithmetic
with the same taps on any device. ``launches`` counts the kernel's
launches, ``launches_f64`` those in float64.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import torch
import torch.nn.functional as F

from ._counts import count_launch, reset_launches

# each storage type's arithmetic type (ATen's accscalar_t), which the
# taps' weights take
ACC = {torch.float32: torch.float32, torch.float64: torch.float64,
       torch.bfloat16: torch.float32, torch.float16: torch.float32}
SMEM_BYTES = 48 * 1024  # a block's input lines, without opting in to more


@functools.lru_cache(maxsize=64)
def _resize_taps(length, size, device, dtype):
    """The linear resize from ``length`` to ``size`` samples as each
    output sample's two taps and weight, by ATen's ``align_corners=False``
    rule (which the JAX package's ``resize_linear`` copies): pos =
    max((j + 0.5) * scale - 0.5, 0), scale = length / size rounded to
    ``dtype``, the product and the difference rounded once (ATen
    contracts them into a fused multiply-add); lo = floor(pos), hi =
    min(lo + 1, length - 1), frac = pos - lo. ``dtype`` is the
    arithmetic type (``ACC``). Returns lo, hi [size] int32 and frac
    [size] in ``dtype``, on ``device`` (ordinary tensors, also when first
    asked for under ``inference_mode``: the cache outlives it)."""
    scale = Fraction((torch.tensor(float(length), dtype=dtype) / size).item())
    half = Fraction(1, 2)
    with torch.inference_mode(False):
        pos = torch.tensor([max(float(scale * (j + half) - half), 0.0)
                            for j in range(size)], dtype=torch.float64)
        pos = pos.to(dtype)
        lo = torch.floor(pos)
        frac = pos - lo
        lo = lo.to(torch.int32)
        hi = torch.clamp(lo + 1, max=length - 1)
        return lo.to(device), hi.to(device), frac.to(device)


def relu_resize_cat_torch(h, size, skip=None):
    """Plain PyTorch version: relu(h) [B, C, L] resized to ``size``
    samples by the taps of ``_resize_taps``, x[lo] * (1 - frac) +
    x[hi] * frac in the arithmetic type (``ACC``), rounded once to
    ``h``'s dtype, with ``skip`` [B, Cs, size] concatenated after."""
    acc = ACC.get(h.dtype, h.dtype)
    lo, hi, frac = _resize_taps(h.shape[-1], size, h.device, acc)
    x = F.relu(h).to(acc)
    out = x.index_select(-1, lo) * (1 - frac) + x.index_select(-1, hi) * frac
    out = out.to(h.dtype)
    return out if skip is None else torch.cat([out, skip], dim=1)


def plan(B, C, Cs, L_in, L_out, itemsize, pointers):
    """The kernel's launch layout: channels a block ``G`` (its input
    lines in at most ``SMEM_BYTES`` of shared memory), the skip elements
    each of the ``ceil(C / G)`` blocks of a row copies, whether every
    row, group and share starts on a 16-byte boundary (``pointers``: the
    tensors' addresses), so that the kernel moves 16-byte vectors, and
    whether the lines are staged: one that does not fit is read from
    ``h`` by one block a channel (G = 1)."""
    G = min(C, SMEM_BYTES // (L_in * itemsize))
    staged = G >= 1
    G = max(G, 1)
    n = 16 // itemsize
    per_group = -(-Cs * L_out // -(-C // G))  # ceil(Cs * L_out / groups)
    share = -(-per_group // n) * n
    vec = (all(p % 16 == 0 for p in pointers)
           and all(v % n == 0 for v in (C * L_in, G * L_in, C * L_out,
                                        Cs * L_out)))
    return G, share, vec, staged


def relu_resize_cat(h, size, skip=None):
    """relu(h) [B, C, L] linearly resized to ``size`` samples
    (``align_corners=False``), then ``skip`` [B, Cs, size] (if given)
    after its channels: [B, C + Cs, size], in one kernel launch on the
    current stream of ``h``'s device. ``h`` and ``skip``: contiguous CUDA
    tensors of one dtype (float32, float64, bfloat16 or float16) on one
    device."""
    if h.dtype not in ACC:
        raise TypeError(f"relu_resize_cat takes float32, float64, bfloat16 "
                        f"or float16, got {h.dtype}")
    if h.dim() != 3 or not h.is_contiguous() or min(h.shape[1:]) < 1:
        raise ValueError(f"relu_resize_cat takes a contiguous [B, C, L] h "
                         f"(C, L >= 1), got shape {tuple(h.shape)}, strides "
                         f"{h.stride()}")
    size = int(size)
    if size < 1:
        raise ValueError(f"relu_resize_cat: size must be positive, got {size}")
    B, C, L_in = h.shape
    Cs = 0
    if skip is not None:
        if (skip.dtype != h.dtype or skip.device != h.device
                or skip.dim() != 3 or not skip.is_contiguous()
                or skip.shape[0] != B or skip.shape[2] != size):
            raise ValueError(
                f"relu_resize_cat: skip must be a contiguous [{B}, Cs, {size}] "
                f"{h.dtype} tensor on {h.device}, got {tuple(skip.shape)} "
                f"{skip.dtype} on {skip.device}")
        Cs = skip.shape[1]
    if h.device.type != "cuda":
        raise ValueError(f"no relu_resize_cat kernel for device {h.device}")
    lo, hi, frac = _resize_taps(L_in, size, h.device, ACC[h.dtype])
    out = torch.empty((B, C + Cs, size), dtype=h.dtype, device=h.device)
    if B == 0:
        return out
    G, share, vec, staged = plan(B, C, Cs, L_in, size, h.element_size(),
                                 [t.data_ptr() for t in (h, out)
                                  + ((skip,) if Cs else ())])
    _enqueue(h, skip if Cs else None, lo, hi, frac, out,
             (B, C, Cs, L_in, size, G, share, int(vec), int(staged)))
    count_launch(relu_resize_cat, h.dtype)
    return out


reset_launches(relu_resize_cat)


def _enqueue(h, skip, lo, hi, frac, out, sizes):
    """Launch the kernel on the current stream of ``h``'s device,
    uncounted (``relu_resize_cat`` counts its launches)."""
    from . import _build

    lib = _build.library()
    entry = {torch.float32: lib.cm_relu_resize_cat_f32,
             torch.float64: lib.cm_relu_resize_cat_f64,
             torch.bfloat16: lib.cm_relu_resize_cat_bf16,
             torch.float16: lib.cm_relu_resize_cat_f16}[h.dtype]
    with torch.cuda.device(h.device):
        err = entry(h.data_ptr(), None if skip is None else skip.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), frac.data_ptr(),
                    out.data_ptr(), *sizes,
                    torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(lib, err, "relu_resize_cat")
