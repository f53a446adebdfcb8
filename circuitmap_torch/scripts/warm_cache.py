"""Build the CUDA kernel library and the host library and run the
pipeline once for deployment shapes (port of
``scripts_tpu/warm_cache.py``).

``python -m circuitmap_torch warm-cache --shape 1000x20000 --iters 50``

A fresh checkout pays nvcc's build of the kernel library (~30 s on an
H100 host) and g++'s of the host library (``utils/native.py``, a few
seconds), and a process's first fit pays CUDA and cuDNN set-up. A
deployment knows its shapes in advance; running this once after install
(or per image build) moves the build out of the first real experiment:
the library lands in the build directory (``--cache-dir``, else
``$CIRCUITMAP_TORCH_BUILD_DIR``, else ``circuitmap_torch/_build``) under
a name that hashes the sources, and every later process loads it.

The warmer executes the *public* entry path — ``NeuralDemixer.__call__``
then ``Model.fit`` — on synthetic data of the requested shape, with the
same knobs ``run_main.py`` exposes, so it routes exactly like the
deployment call. Synthetic values are irrelevant; they only need to be
numerically tame.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

from . import add_device_argument
from ..utils.synthetic import parse_shape as _parse_shape
from ..utils.synthetic import synthetic_experiment


def warm_one(N, K, *, iters, msrmp, powers, demixer, transfer_dtype,
             T=900, verbose=True, device=None):
    from ..demix.demixer import resolve_transfer_dtype
    from ..model import Model

    psc, stim = synthetic_experiment(N, K, T=T, powers=powers)
    t0 = time.perf_counter()
    if demixer is not None:
        traces = demixer(psc, keep_on_device=True,
                         transfer_dtype=resolve_transfer_dtype(transfer_dtype))
    else:
        traces = psc
    fit_options = {"msrmp": msrmp, "iters": iters,
                   "save_histories": False,
                   "powers": [float(p) for p in powers]}
    model = Model(N)
    model.fit(traces, stim, method="caviar", fit_options=fit_options,
              device=device)
    np.asarray(model.state["mu"][:1])  # settle before timing
    dt = time.perf_counter() - t0
    if verbose:
        print("warmed N=%d K=%d in %.1fs (build + one fit)" % (N, K, dt))
    return dt


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch warm-cache",
        description="build the CUDA kernels and run the demix+CAVIaR "
                    "pipeline once for given shapes")
    parser.add_argument("--shape", type=_parse_shape, nargs="+",
                        required=True, metavar="NxK",
                        help="one or more problem shapes, e.g. "
                             "1000x20000 500x5000")
    parser.add_argument("--iters", type=int, default=50,
                        help="fit iterations; match the deployment value")
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--powers", type=float, nargs="+",
                        default=[45.0, 55.0, 65.0])
    parser.add_argument("--demixer", default=None,
                        help="demixer checkpoint (.npz) to warm the "
                             "demix stage with; 'default' for a fresh "
                             "default-architecture net; omit to warm "
                             "raw-trace fits")
    parser.add_argument("--transfer-dtype", default="f16",
                        choices=["f32", "f16", "int8", "int4", "int4d2"],
                        help="trace wire to warm")
    parser.add_argument("--trace-len", type=int, default=900)
    parser.add_argument("--cache-dir", default=None,
                        help="the build directory to fill (sets "
                             "$CIRCUITMAP_TORCH_BUILD_DIR for this "
                             "process; default: that variable, else "
                             "circuitmap_torch/_build)")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    import torch

    from .._device import resolve_device
    from ..ops import _build

    if args.cache_dir:
        Path(args.cache_dir).mkdir(parents=True, exist_ok=True)
        os.environ[_build.BUILD_DIR_ENV] = str(Path(args.cache_dir).resolve())
    device = resolve_device(args.device)
    from ..utils import native

    t0 = time.perf_counter()
    native.library()
    print("host library ready in %.1fs (%s)" % (
        time.perf_counter() - t0, "built" if native.built else "cached"))
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library()
        print("kernel library ready in %.1fs (%s)" % (
            time.perf_counter() - t0,
            "built" if _build.build_seconds is not None else "cached"))

    demixer = None
    if args.demixer == "default":
        from ..demix.demixer import NeuralDemixer
        demixer = NeuralDemixer(seed=0, device=device)
    elif args.demixer:
        from ..demix.demixer import NeuralDemixer
        demixer = NeuralDemixer(path=args.demixer, device=device)

    total = 0.0
    for N, K in args.shape:
        total += warm_one(N, K, iters=args.iters, msrmp=args.msrmp,
                          powers=args.powers, demixer=demixer,
                          transfer_dtype=args.transfer_dtype,
                          T=args.trace_len, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    cache = _build.build_dir()
    n_entries = (sum(1 for p in cache.glob("*.so")) if cache.is_dir()
                 else None)
    print("warm-cache done: %d shape(s) in %.1fs; cache=%s entries=%s"
          % (len(args.shape), total, cache, n_entries))
    if device.type != "cuda":
        print("note: a CPU fit launches no CUDA kernel, so only the host "
              "library was built; run on the GPU (no --device cpu) to "
              "build the kernels too")
