"""Result fields to the host: the pull that ends a fit.

``to_host(fields)`` turns each tensor of a dict into a host numpy array
by one of three paths, chosen by ``plan`` from the tensor's device and
byte size alone:

  * ``"host"``: a CPU tensor, returned as its ``.numpy()`` view (no
    copy);
  * ``"pinned"``: a CUDA tensor of at least ``PINNED_MIN_BYTES``, copied
    without blocking into a page-locked block of PyTorch's caching host
    allocator (``torch.empty(..., pin_memory=True)``) and returned as a
    numpy view of that block. The copy runs at the link's speed, with no
    staging buffer and no first touch of fresh pages. The view holds the
    block: the allocator takes a block back only when the last array
    viewing it dies, so no array returned by one call shares memory with
    one returned by another, and a freed block takes a later call's copy;
  * ``"pageable"``: any other device tensor, ``.cpu().numpy()``. Small
    fields (scalars, [N] vectors) take it, so they never grow the pinned
    cache; below the floor it is also the faster of the two (PERF.md §6).

Every pinned copy of one call is queued on its tensor's current stream
before the call waits, once a stream. The arrays are writable and hold
the tensor's bytes in its dtype and shape; a pinned one is C-contiguous.

``to_host.plans`` counts the fields pulled by path (``{"pinned": n,
"pageable": n}``, ``ops/_counts.py::count_plan``) and
``to_host.plan_bytes`` their bytes; ``reset_pulls()`` clears both.
"""

from __future__ import annotations

import torch

from ..ops._counts import count_plan

# Where a copy into a cached page-locked block overtakes ``.cpu()`` on
# an H100: 0.051 against 0.072 ms at 256 KiB, 0.056 against 0.050 ms at
# 64 KiB (PERF.md §6; chip_smoke.py's phase 3f re-measures it).
PINNED_MIN_BYTES = 1 << 18


def plan(device, nbytes):
    """The path a tensor on ``device`` of ``nbytes`` takes to the host:
    ``"host"``, ``"pinned"`` or ``"pageable"``."""
    if device.type == "cpu":
        return "host"
    if device.type == "cuda" and nbytes >= PINNED_MIN_BYTES:
        return "pinned"
    return "pageable"


def pinned_copy(t):
    """A C-contiguous page-locked host copy of the CUDA tensor ``t``,
    queued on ``t``'s current stream: (the copy, that stream)."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return (buf.copy_(t, non_blocking=True),
            torch.cuda.current_stream(t.device))


def to_host(fields):
    """``fields`` ({name: value}) with every tensor made a host numpy
    array; other values pass through. See the module's docstring."""
    out, streams = {}, set()
    for name, v in fields.items():
        if not isinstance(v, torch.Tensor):
            out[name] = v
            continue
        t = v.detach().as_subclass(torch.Tensor)
        how = plan(t.device, t.nbytes)
        if how != "host":
            count_plan(to_host, how)
            to_host.plan_bytes[how] = (to_host.plan_bytes.get(how, 0)
                                       + t.nbytes)
        if how == "pinned":
            t, stream = pinned_copy(t)
            streams.add(stream)
        elif how == "pageable":
            t = t.cpu()
        out[name] = t
    for stream in streams:
        stream.synchronize()
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def reset_pulls():
    """Both of ``to_host``'s counts cleared."""
    to_host.plans, to_host.plan_bytes = {}, {}


reset_pulls()
