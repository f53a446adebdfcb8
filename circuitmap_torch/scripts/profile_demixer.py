"""Profile of the demixer at the main path's shape (port of
``scripts_tpu/profile_demixer.py``).

One device-resident forward pass over [K, 900] traces (peak
normalisation, the U-Net, the monotone-decay filter, in the public
call's chunks of 4,096 rows), its wall time, and its device time by
kernel name from ``torch.profiler`` (CUDA kernels; CPU operations when
run on the CPU). Beside it, the demix phase of the main path split into
its parts on the same block: the host's encode of the main path's
int4d2 trace wire (mean-pool by 2, per-trace peak/7 codes, two a byte),
the upload of the encoded bytes, their decode and upsample on the
device, and the whole public ``NeuralDemixer.__call__`` (host array in,
device tensor out). The checkpoint is the JAX script's; every
checkpoint of the zoo has the same network, so the times hold for the
main path's int4d2 QAT one.

    python -m circuitmap_torch profile-demixer [K] [--bf16]
"""

import argparse
import json
import time

import numpy as np

from . import add_device_argument


def aggregate_profile(prof, device_type):
    """Sum event self times by name (ms): the CUDA kernels on a GPU (not
    the operators that launched them, which the profiler also credits
    with their kernels' time), the CPU operations on the CPU."""
    from torch.autograd import DeviceType

    totals = {}
    for evt in prof.key_averages():
        if device_type == "cuda":
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        else:
            us = evt.self_cpu_time_total
        if us > 0:
            totals[evt.key] = totals.get(evt.key, 0.0) + us / 1e3
    return totals


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer
    from ..ops.monotone import monotone_decay_filter
    from ..solvers._common import unpack_int4_traces
    from ..utils.quant import encode_int4_traces

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch profile-demixer",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("K", type=int, nargs="?", default=20000)
    ap.add_argument("--bf16", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    K = args.K

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kw = {"compute_dtype": torch.bfloat16} if args.bf16 else {}
    demixer = NeuralDemixer(path="demixers/nwd_ie_ChroME2f.npz", device=dev,
                            **kw)
    np.random.seed(0)
    traces = np.random.randn(K, 900).astype(np.float32)

    # device-resident input: the forward alone, without the wire
    x = torch.as_tensor(traces, device=dev)
    demixer.net.eval()

    def fwd(a, chunk=4096):
        with torch.inference_mode(), demixer._precision(deterministic=True):
            return torch.cat([monotone_decay_filter(
                demixer._demix_batch(a[i:i + chunk]), start=500)
                for i in range(0, a.shape[0], chunk)])

    fwd(x)
    settle()  # cuDNN's algorithm choice and the allocator's pools

    def best_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            settle()
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    forward_ms = best_ms(lambda: fwd(x))
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fwd(x)
        settle()
    totals = aggregate_profile(prof, dev.type)

    # the demix phase's parts: host encode, upload, device decode
    t0 = time.perf_counter()
    for _ in range(3):
        packed, scale = encode_int4_traces(traces, decimate=2)
    encode_ms = (time.perf_counter() - t0) / 3 * 1e3
    packed_t, scale_t = (torch.from_numpy(np.ascontiguousarray(a))
                         for a in (packed, scale))
    upload_ms = best_ms(lambda: (packed_t.to(dev), scale_t.to(dev)))
    decode_ms = best_ms(lambda: unpack_int4_traces(packed, scale, 900, 2,
                                                   dev))
    call_ms = best_ms(lambda: demixer(traces, keep_on_device=True,
                                      transfer_dtype="int4d2",
                                      verbose=False))

    top = sorted(totals.items(), key=lambda kv: -kv[1])[:25]
    print(json.dumps({
        "K": K,
        "bf16": args.bf16,
        "device": str(dev),
        "forward_wall_ms_best": round(forward_ms, 3),
        "device_total_ms": round(sum(totals.values()), 3),
        "top_ops_ms": {k: round(v, 3) for k, v in top},
        "wire": "int4d2",
        "wire_bytes": int(packed.nbytes + scale.nbytes),
        "host_encode_ms": round(encode_ms, 3),
        "upload_ms": round(upload_ms, 3),
        "device_decode_ms": round(decode_ms, 3),
        "demix_call_ms_best": round(call_ms, 3),
    }, indent=1))
