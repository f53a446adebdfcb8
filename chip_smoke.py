#!/usr/bin/env python3
"""Smoke run of circuitmap_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``circuitmap_torch/csrc``, holds each
against its plain PyTorch version at the shapes its path gives it, then
drives the paths through the user entry points and checks that each fit
recovers the simulated weights. One kernel, the cluster sweep
(``csrc/sweep_cluster.cuh``), serves both sweep schedules:
``sweep_blocked`` (a block of 2 or more rows a step, 8 by default;
above 32, sub-steps of at most 32) and ``sweep_row`` (one row a step)
name its two uses.

* the main path: ``simulate`` (N=1000, K=20000), the int4d2 demixer with
  its QAT checkpoint, and a 50-iteration CAVIaR fit through
  ``Model.fit`` (8 rows a step);
* the strictly sequential fit: the same fit at ``sweep_block_size=1``
  (one row a step);
* an ``"auto"`` fit past the old single-SM kernel's K limit (N=200,
  K=60000), which must take 8 rows a step;
* ``caviar_many`` on 4 cross-validation folds of the main path's map
  (each holds out one quarter of the trials), batched (one row a step,
  E=4) and sequential, and on a ragged stack of 4 folds with
  18000..12000 trials at block 8 (8 rows a step, E=4);
* the other solvers on the main path's demixed traces: CAVI-SnS through
  ``Model.fit`` (50 iterations; its lam sweep is the row kernel, its
  refit the Laplace kernel; a float64 witness with the plain lam sweep,
  the kernel held against it on each of its sweeps),
  MBCS (50 iterations, Monte Carlo and exact noise model; plain PyTorch)
  and MBCS-ARD (30 iterations; its sweep is the row kernel);
* the main-path fit with ``track_elbo`` (equal to the untracked fit)
  and with ``elbo_tol=1e-4`` (the sweep launches once a live iteration);
* the streaming and batched fits (phases 17-21): the main-path fit at
  ``sweep_block_size=16``; ``caviar_resumable`` in segments of 10,
  straight and resumed from its file, against the one-shot fit;
  ``OnlineCaviar`` (one update of all trials against the batch fit, a
  stream of 10 blocks of 2,000 trials with each update's latency, a
  stream saved after block 5 and reloaded); ``closed_loop_map`` (N=1000,
  2,000 trials a round, at most 5 rounds); ``sns_many`` and
  ``mbcs_many`` on the 4 folds, batched against sequential, and a
  ragged ``sns_many`` against the single fits;
* the fits past the kernels' compile-time limits (phase 3c): the main
  path at ``sweep_block_size=64`` and on a re-levelled stim of 24 power
  levels;
* demixer training (phase 22): the int4d2 QAT fine-tune of
  ``demixers/nwd_ie_ChroME2f.npz`` on 50,000 generated pairs, 3 epochs
  (its first 3 steps against the CPU's, its validation loss against the
  starting checkpoint's, save and reload, one profiled epoch), then the
  main map demixed by the trained network and fitted;
* ``fit_psc_templates`` on 1,000 demixed traces (phase 23); the
  continuous 20 kHz simulation at N=300 over 300 s, demixed by both
  networks and fitted (phase 24); ``Model.summary``,
  ``split_single_ensemble`` and ``connection_waveforms`` on the main
  path's fit (phase 25);
* the fit server (phase 26): ``circuitmap_torch.serve`` in process on a
  thread (CUDA, port 0): ``/health``, ``/warm`` at [[1000, 20000]], the
  main path's ``/fit`` with the raw PSC on the int4d2 wire, sparse stim
  and ``demix=true`` against the in-process chain (and again with
  ``return_fields`` and with the int8 lam wire: wall, server seconds,
  bytes), ``/fit_many`` on phase 10's folds against ``caviar_many``,
  phase 19's stream over ``/stream/<name>/update`` against
  ``OnlineCaviar``; then ``python -m circuitmap_torch serve`` in a
  subprocess: 5 blocks, SIGTERM (exit 0, the stream saved), a second
  server loads the stream and takes 5 more blocks, equal to the
  uninterrupted stream. No phase imports ``yaml``: the ``fit`` command
  is left to the CPU tests;
* the multi-device layer on the one card (phase 27, ``phase_mesh``):
  ``Model.fit(mesh=)`` over a trial mesh of two shards on cuda:0 (the
  counterpart of JAX's virtual mesh; B2 once an iteration per distinct
  device, no sweep kernel) with a float64 witness on two CPU shards;
  ``caviar_sharded_distributed`` in two processes on cuda:0 joined by
  gloo (NCCL refuses two ranks on one card), uneven halves of the
  trials; ``caviar_many``/``sns_many(mesh=)`` on the folds;
  ``caviar_resumable(mesh=)`` stopped and resumed;
  ``OnlineCaviar(mesh=)`` over phase 19's stream; the demixer over the
  mesh and a ``FitService(mesh_devices=2)`` ``/fit``. NCCL and more
  than one card are not exercised;
* the workflow commands of ``python -m circuitmap_torch`` (phase 28,
  ``phase_workflows``) at the main map's width, each through its
  ``main(argv)`` in process and held against its in-process
  counterpart: ``loho-cv``, ``fanout-jobs`` (the emitted bash script
  run over the same 2 folds, each a ``loho-cv --fold I`` worker in a
  subprocess), ``pipeline-1v10`` (its fits and export),
  ``distributed-fit`` (two gloo processes on cuda:0),
  ``train-qat-demixer`` and ``export-ckpt``, ``denoise-grids``,
  ``simulations``, ``downsampling``, ``signal-fidelity`` and
  ``design-study``. ``continuous`` (YAML) and ``pipeline-1v10``'s figure
  (matplotlib) are left to the CPU tests;
* float64 on the card (phase 29, ``phase_float64``): the sweep at 8
  rows (also off chip), at one row and batched (E=4), and the Laplace
  refit, each in float64 against its float64 plain version; a float64
  ``Model.fit`` of the main map (50 float64 B1 and 51 float64 B2
  launches) against the same fit with the float64 plain sweep; a
  float64 CAVI-SnS fit;
* the Operations and Measurement commands (phase 30,
  ``phase_commands``): ``doctor``, ``hw-smoke``, ``warm-cache``,
  ``memory-cliff --quick`` and ``compile-study --warm-only`` in
  processes of their own, ``profile-fit``, ``profile-demixer``,
  ``profile-online``, ``scaling-study --quick`` and ``wire-study`` (one
  seed) in process, every output in a temporary directory;
* the host library (phase 31, ``phase_native``): the stim sparsify, the
  int4d2 and int8 encodes, the int4d2 decode and the windows with their
  charges of phase 24's timeline, each at full size bit for bit against
  its numpy version, host ms of both; then the host stages it now
  carries (phase 30's ``profile-fit`` stim upload and ``profile-demixer``
  host encode, phase 5's end to end and fit only);
* data-parallel demixer training (phase 32, ``phase_mesh_training``):
  ``NeuralDemixer.train(mesh=["cuda:0"] * 2)`` on phase 22's data, its
  first 3 steps and those of ``mesh=["cuda:0", "cpu"]`` (two replicas,
  the global batch's BatchNorm) against the one-device steps, one epoch
  of each (val loss within 5%), a profiled 100-step mesh epoch;
* the sweep-frontier study (phase 33, ``phase_frontier``) at N=1000,
  K=20000, seed 0: blocks 1, 8, 10, 12, 16 and perm8, each arm's
  truth-R2 at least 0.98.

The sweep is held against its plain version at both schedules at
N=1000/K=20000 and N=200/K=100000, at one row a step at N=16/K=300000
(r in device memory), at E=4 (K=15000, one row a step; the
ragged stack's inert padding and per-experiment scalars at 8 rows a
step), at the pinned blocks 7, 12, 16 and 32 and at 16 power levels
(phase 3b), at 24, 64 and 1024 power levels and at 48, 64 and 125
rows a block (phase 3c), with the gate on also for agreement between
the CTAs of each cluster, and at one row a step at the arguments
CAVI-SnS and MBCS-ARD give it (phase 12); the Laplace kernel at [1000]
and [4, 1000] lanes and at 17, 25, 65 and 1025 buckets,
timed on the device (a CUDA graph of 20 launches) and per wrapper call,
its bound counting the Armijo candidates those inputs need; the U-Net's
up-block epilogue kernel (ReLU, linear resize, skip concat) at its four
shapes and 4096 rows, held to ATen's ops to the last bit in float32 and
bfloat16 and timed beside them (phase 3d), and its four launches a
chunk of the main path's int4d2 demix (phase 5). One warm
main-path fit runs under torch.profiler (phase 5b: the top device
operations, the Laplace total, the device's idle share), and one warm
2-iteration CAVI-SnS fit (phase 13).

Every kernel's launch count is set to 0 just before each path and read
just after it, float32 and float64 launches apart (each float64
instance has its own record). Phases print ``# ...`` lines; any failure raises and the
exit code is non-zero. The line before the last is a JSON record of
every kernel (launches on each path, error against the plain version,
times, bound and the share of it, cluster shape); the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F64_FLOPS = 34e12       # H100 SXM f64 outside the tensor cores
N, K, H = 1000, 20000, 10
POWERS = (45.0, 55.0, 65.0)
CHECKPOINT = HERE / "demixers" / "nwd_ie_ChroME2f_int4d2qat.npz"


T0 = time.time()


def log(msg):
    """A ``# ...`` line; a phase's first line carries the call's elapsed
    seconds."""
    if msg.startswith("phase"):
        msg = f"[{time.time() - T0:7.1f} s] {msg}"
    print(f"# {msg}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(enqueue, launches=20, replays=10):
    """Device milliseconds of one launch: ``launches`` calls of
    ``enqueue`` (a kernel's C entry on prepared tensors) captured in a
    CUDA graph, each replay timed by CUDA events; the median over
    ``replays`` divided by ``launches``. No host work is inside."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            enqueue()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            enqueue()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def call_ms(fn, reps=20, warmup=3):
    """Median wall milliseconds of ``fn`` and a synchronise (host
    clock): what a caller pays when the host sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sweep_inputs(seed=0, n=N, k=K, powers=POWERS, block=8):
    """Bench-like sweep inputs at the main-path shape (or n x k): H
    targets per trial at one of the ``powers`` (three by default), ~5%
    connected neurons, spike posteriors on targeted trials, power-curve
    means near the simulator's phi, an order of the blocks of ``block``
    rows and a row order."""
    import torch

    rng = np.random.default_rng(seed)
    stim = np.zeros((n, k), np.float32)
    cols = np.repeat(np.arange(k), H)
    stim[rng.integers(0, n, k * H), cols] = rng.choice(powers, k * H)
    lam = np.where(stim > 0, rng.uniform(0, 1, (n, k)), 0).astype(np.float32)
    mu = np.where(rng.random(n) < 0.05, rng.uniform(10, 40, n), 0).astype(np.float32)
    spikes = (rng.random((n, k)) < lam).astype(np.float32)
    y = (mu @ spikes + rng.normal(0, 1, k)).astype(np.float32)
    d = dict(
        y=y, stim=stim, mu=mu, beta=rng.uniform(0.5, 3, n).astype(np.float32),
        lam=lam, m0=rng.uniform(0.2, 0.25, n).astype(np.float32),
        m1=rng.uniform(10, 15, n).astype(np.float32),
        lam_mask=(rng.random(k) > 0.02).astype(np.float32),
        powers=np.asarray(powers, np.float32),
        border=rng.permutation(-(-n // block)).astype(np.int64),
        order=rng.permutation(n).astype(np.int64))
    out = {key: torch.from_numpy(v).cuda() for key, v in d.items()}
    out["power_counts"] = torch.stack(
        [(out["stim"] == p).sum(1) for p in powers], 1).float()
    return out


def sweep_call(fn, a, gate_active, dtype=None, **kw):
    import torch

    t = {k: (v.to(dtype) if dtype is not None and v.is_floating_point() else v)
         for k, v in a.items()}
    return fn(t["y"], t["stim"], t["mu"], t["beta"], t["lam"], 0.1,
              t["m0"], t["m1"], t["lam_mask"], t["powers"], t["power_counts"],
              t["border"], 0.35, 3.0, float(gate_active), **kw)


def counters():
    """Each kernel's wrappers, whose ``launches`` count its launches."""
    from circuitmap_torch.ops import (laplace_cuda, resize_cuda, sweep_cuda,
                                      sweep_row_cuda)

    return {
        "sweep_blocked": (sweep_cuda.sweep_spikes_blocked,
                          sweep_cuda.sweep_spikes_blocked_batched),
        "laplace": (laplace_cuda.laplace_from_stats,),
        "sweep_row": (sweep_row_cuda.sweep_spikes_row,
                      sweep_row_cuda.sweep_spikes_row_batched),
        "relu_resize_cat": (resize_cuda.relu_resize_cat,),
    }


def reset_counts():
    from circuitmap_torch.ops._counts import reset_launches

    for fns in counters().values():
        reset_launches(*fns)


def read_counts():
    """Launches per wrapper since the last reset: ``name`` in float32,
    ``name_f64`` in float64."""
    out = {}
    for fns in counters().values():
        for fn in fns:
            out[fn.__name__] = fn.launches - fn.launches_f64
            out[fn.__name__ + "_f64"] = fn.launches_f64
    return out


def kernel_launches(counts):
    """Launches per kernel from read_counts(): ``kernel`` the float32
    instances', ``kernel_f64`` the float64 ones'."""
    out = {}
    for kernel, fns in counters().items():
        out[kernel] = sum(counts[fn.__name__] for fn in fns)
        out[kernel + "_f64"] = sum(counts[fn.__name__ + "_f64"] for fn in fns)
    return out


def launch_dict(b1, b2, b3, f64=(0, 0, 0)):
    """kernel_launches()'s dict of B1, B2 and B3 launches in float32,
    and in float64 ``f64``; no launch of the demixer's epilogue (U1)."""
    return {"sweep_blocked": b1, "laplace": b2, "sweep_row": b3,
            "sweep_blocked_f64": f64[0], "laplace_f64": f64[1],
            "sweep_row_f64": f64[2], "relu_resize_cat": 0,
            "relu_resize_cat_f64": 0}


def fit_kernel_launches(launches):
    """kernel_launches()'s dict without the demixer's epilogue (U1): the
    fit's kernels alone."""
    return {k: v for k, v in launches.items()
            if not k.startswith("relu_resize_cat")}


def cluster_fields(E, K, rows, P=len(POWERS)):
    """The launch plan's shape for the ``kernels`` line."""
    from circuitmap_torch.ops import sweep_cuda as sc

    plan = sc.launch_plan(E, K, rows, P)
    return dict(cluster_size=plan.cluster, cols_per_cta=plan.cols,
                on_chip=plan.on_chip, ring_depth=plan.depth)


def check_cta_agreement(out, plain, a, rows, what):
    """The gates agree between the CTAs of a cluster: with the gate on,
    no row of the kernel's output ``out`` may be all zero over one CTA's
    column slice but nonzero over another's. A slice counts where the
    plain version's output ``plain`` (same inputs, gate on) is nonzero
    in it: a column with stim > 0 and mask > 0 can still hold an est of
    exactly 0 where the sigmoid underflows, so the rows that stim and
    mask alone would flag are printed beside. The gate-off comparison
    cannot see a disagreement: every gate is 1 there."""
    import torch.nn.functional as F
    from circuitmap_torch.ops import sweep_cuda as sc

    *lead, n, k = out.shape
    E = lead[0] if lead else 1
    plan = sc.launch_plan(E, k, sc.sub_steps(rows)[1], a["powers"].shape[0])
    pad = plan.cluster * plan.cols - k

    def slices(x):
        return F.pad(x, (0, pad)).reshape(*x.shape[:-1], plan.cluster,
                                          plan.cols).any(-1)

    live = slices(out != 0)
    targeted = slices((a["stim"] > 0) & (a["lam_mask"] > 0).unsqueeze(-2))
    by_stim = live.any(-1) & (targeted & ~live).any(-1)
    split = live.any(-1) & (slices(plain != 0) & ~live).any(-1)
    log(f"{what}: {int(split.sum())} rows zero on a CTA slice where the "
        f"plain version is not, and nonzero on another ({plan.cluster} "
        f"CTAs of {plan.cols} columns); {int(by_stim.sum())} rows zero on "
        "a slice with stim > 0 and mask > 0 (est underflows to 0 there "
        "in the plain version too)")
    if split.any():
        raise AssertionError(f"{what}: the CTAs of a cluster disagree on "
                             f"{int(split.sum())} gates")


def phase_sweep():
    import torch
    from circuitmap_torch.ops import sweep_cuda as sc

    log("phase 3: cluster sweep at 8 rows a step vs plain version (N=1000, "
        "K=20000, P=3)")
    a = sweep_inputs()
    ker = sweep_call(sc.sweep_spikes_blocked, a, 0)
    plain = sweep_call(sc.sweep_spikes_blocked_torch, a, 0)
    exact = sweep_call(sc.sweep_spikes_blocked_torch, a, 0, torch.float64)
    torch.cuda.synchronize()
    err = (ker - plain).abs().max().item()
    err64_k = (ker.double() - exact).abs().max().item()
    err64_p = (plain.double() - exact).abs().max().item()
    log(f"gate off: max |kernel - plain| = {err:.3e}; vs float64 plain: "
        f"kernel {err64_k:.3e}, f32 plain {err64_p:.3e}")
    if not torch.allclose(ker, plain, rtol=1e-4, atol=1e-5):
        raise AssertionError("sweep kernel disagrees with its plain version "
                             "beyond rtol 1e-4 / atol 1e-5 (gate off)")
    ker1 = sweep_call(sc.sweep_spikes_blocked, a, 1)
    plain1 = sweep_call(sc.sweep_spikes_blocked_torch, a, 1)
    # a row is gated off when its est was nonzero but its output is all
    # zero; a borderline iso >= msrmp may flip under another reduction
    # order, hence an allowance of 0.5% of the rows
    off_k = (ker1.sum(1) == 0) & (ker.sum(1) > 0)
    off_p = (plain1.sum(1) == 0) & (plain.sum(1) > 0)
    flips = int((off_k != off_p).sum())
    log(f"gate on: {int(off_k.sum())} rows gated off; {flips} gate "
        f"decisions differ from the plain version")
    if flips > 0.005 * N:
        raise AssertionError(f"{flips} gate decisions differ (> 0.5% of rows)")
    check_cta_agreement(ker1, plain1, a, 8, "8 rows a step, gate on")
    ms = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked, a, 1))
    plain_ms = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked_torch, a, 1),
                       reps=5, warmup=1)
    bound_ms = 3 * N * K * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"sweep kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, byte bound "
        f"{bound_ms:.4f} ms (3*N*K*4 B at 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of the bound")
    return dict(name="sweep_blocked", route="cuda",
                source="circuitmap_torch/csrc/sweep_cluster.cuh",
                replaces="circuitmap_tpu/ops/sweep_pallas.py:658",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                bound_share=bound_ms / ms, rows_per_step=8,
                **cluster_fields(1, K, 8)), (a, ker1)


# (C, L_in, L_out, Cs) of the U-Net's up blocks ublock1..4 at 900 samples
UNET_UP = ((16, 32, 65, 32), (16, 80, 162, 16), (16, 193, 387, 16),
           (4, 804, 900, 0))
DEMIX_CHUNK = 4096


def phase_epilogue():
    """The U-Net's up-block epilogue kernel (``csrc/resize.cu``: ReLU,
    linear resize, skip concat) at its four shapes and a 4096-row chunk,
    against ATen's ops (relu, ``F.interpolate``, cat: the path it
    replaced, the ``library_ms`` yardstick) and its plain version; device
    time from a CUDA graph of 20 launches. The bfloat16 instance is held
    to ATen's bfloat16 ops at the same shapes. Its launches are counted
    on the paths (phase 5: four a chunk of the main path's demix)."""
    import torch
    import torch.nn.functional as F
    from circuitmap_torch.ops import resize_cuda as rc

    log("phase 3d: U-Net up-block epilogue (ReLU, linear resize, skip "
        f"concat) at {DEMIX_CHUNK} rows vs ATen's ops and the plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = plain_ms = library_ms = nbytes = 0
    err, differ, shapes = 0.0, {}, {}
    for C, L_in, L_out, Cs in UNET_UP:
        h = torch.randn(DEMIX_CHUNK, C, L_in, device="cuda", generator=gen)
        skip = (torch.randn(DEMIX_CHUNK, Cs, L_out, device="cuda",
                            generator=gen) if Cs else None)

        def aten(h=h, skip=skip, L_out=L_out):
            out = F.interpolate(F.relu(h), size=L_out, mode="linear",
                                align_corners=False)
            return out if skip is None else torch.cat([out, skip], dim=1)

        for dtype in (torch.float32, torch.bfloat16):
            hd = h.to(dtype)
            sd = None if skip is None else skip.to(dtype)
            got, want = rc.relu_resize_cat(hd, L_out, sd), aten(hd, sd)
            err = max(err, (got.float() - want.float()).abs().max().item())
            differ[str(dtype)[6:]] = (differ.get(str(dtype)[6:], 0)
                                      + int((got != want).sum()))
        k_ms = graph_ms(lambda: rc.relu_resize_cat(h, L_out, skip))
        p_ms = cuda_ms(lambda: rc.relu_resize_cat_torch(h, L_out, skip))
        a_ms = cuda_ms(aten, reps=5, warmup=1)
        b = DEMIX_CHUNK * (C * L_in + (C + 2 * Cs) * L_out) * 4
        shapes[f"{L_in}->{L_out}"] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=a_ms,
            bound_ms=b / PEAK_BYTES_PER_S * 1e3)
        ms, plain_ms, library_ms, nbytes = (ms + k_ms, plain_ms + p_ms,
                                            library_ms + a_ms, nbytes + b)
        log(f"{L_in}->{L_out} (C={C}, skip {Cs}): kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.3f} ms, ATen {a_ms:.3f} ms, bound "
            f"{shapes[f'{L_in}->{L_out}']['bound_ms']:.4f} ms")
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"a chunk: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, ATen "
        f"{library_ms:.3f} ms, byte bound {bound_ms:.4f} ms ({nbytes} B at "
        f"3.35 TB/s), {bound_ms / ms:.1%} of the bound; max |kernel - "
        f"ATen| {err:.3e}, elements that differ {differ}")
    if err > 0:
        raise AssertionError("the epilogue kernel differs from ATen's ops")
    return dict(name="relu_resize_cat", route="cuda",
                source="circuitmap_torch/csrc/resize.cu",
                replaces="none (an XLA gather: circuitmap_tpu/demix/unet.py::"
                         "resize_linear)",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=library_ms,
                bound_share=bound_ms / ms, rows=DEMIX_CHUNK, shapes=shapes,
                differ=differ)


OPS_PER_BUCKET = 30  # one bucket's share of a direction or an objective


def laplace_trips(S, C, levels, pp, pc, what):
    """The first accepted Armijo index j of every lane at each Newton
    step, from the plain version in float64 on the card, printed as a
    distribution. Returns the candidate objectives that a search
    stopping at the first acceptance evaluates: min(j, 40) + 1 a step."""
    from circuitmap_torch.ops import laplace_cuda as lc

    j = lc.accepted_steps(*(t.double() for t in (S, C, levels, pp, pc)))
    none = lc.MAX_BACKTRACK + 1
    classes = {"0": (0, 0), "1-7": (1, 7), "8-15": (8, 15),
               "16-31": (16, 31), "32-40": (32, 40), "none": (none, none)}
    hist = {name: int(((j >= lo) & (j <= hi)).sum())
            for name, (lo, hi) in classes.items()}
    evals = j.clamp(max=lc.MAX_BACKTRACK) + 1
    per_lane = evals.sum(-1).double()
    log(f"{what}: accepted Armijo j over {j.numel()} Newton steps "
        f"(plain version, float64): {hist}; largest j "
        f"{int(j.clamp(max=lc.MAX_BACKTRACK).max())}; candidate objectives a "
        f"lane needs over the {lc.NEWTON_STEPS} steps: mean "
        f"{per_lane.mean().item():.3f}, max {int(per_lane.max())}")
    return int(evals.sum()), hist


def check_laplace(S, C, levels, what):
    """The Laplace kernel against its plain version run in float64 on the
    same inputs (the kernel computes in double from float32 inputs,
    csrc/laplace.cu): at most 0.1% of the neuron lanes beyond rtol 1e-4,
    relative to each lane's largest entry (the covariance's
    off-diagonal can sit near zero, where an entrywise ratio is noise).
    The priors are the default ones, shared by every lane as a fit
    passes them. Times: ``ms`` the kernel's device time (20 launches
    of the C entry on prepared tensors captured in a CUDA graph, the
    replay timed by events), ``call_ms`` the wrapper's wall time per
    call (host clock, synchronised, median of 20)."""
    import torch
    from circuitmap_torch.ops import laplace_cuda as lc

    lanes, P1 = S.shape[:-1], S.shape[-1]
    L = lanes.numel()
    pp = torch.tensor([0.1, 5.0], device="cuda").expand(*lanes, 2)
    pc = torch.tensor([[1e-1, 0.0], [0.0, 1e0]], device="cuda").expand(
        *lanes, 2, 2)
    phi_k, cov_k = lc.laplace_from_stats(S, C, levels, pp, pc)
    phi_x, cov_x = lc.laplace_from_stats_torch(
        *(t.double() for t in (S, C, levels, pp, pc)))
    phi_p, cov_p = lc.laplace_from_stats_torch(S, C, levels, pp, pc)
    torch.cuda.synchronize()

    def rel(x, y):
        d = (x.double() - y.double()).abs().reshape(L, -1).max(1).values
        return d / y.double().abs().reshape(L, -1).max(1).values.clamp(
            min=1e-30)

    r_phi, r_cov = rel(phi_k, phi_x), rel(cov_k, cov_x)
    log(f"{what}: max relative error vs the float64 plain version: kernel "
        f"phi {r_phi.max().item():.3e} cov {r_cov.max().item():.3e}; "
        f"float32 plain phi {rel(phi_p, phi_x).max().item():.3e} cov "
        f"{rel(cov_p, cov_x).max().item():.3e}")
    worst = int(torch.argmax(torch.maximum(r_phi, r_cov)))
    bad_phi, bad_cov = int((r_phi > 1e-4).sum()), int((r_cov > 1e-4).sum())
    log(f"{what}: lanes beyond rtol 1e-4: phi {bad_phi}, cov {bad_cov}; "
        f"worst lane {worst}: rel err phi {r_phi[worst].item():.3e} cov "
        f"{r_cov[worst].item():.3e}")
    if bad_phi > 0.001 * L or bad_cov > 0.001 * L:
        raise AssertionError(f"{what}: Laplace kernel disagrees with its "
                             "plain version on more than 0.1% of lanes at "
                             "rtol 1e-4")
    err = max((phi_k.double() - phi_x).abs().max().item(),
              (cov_k.double() - cov_x).abs().max().item())
    args, _, _ = lc._prepare(S, C, levels, pp, pc)
    ms = graph_ms(lambda: lc._enqueue(args))
    call = call_ms(lambda: lc.laplace_from_stats(S, C, levels, pp, pc))
    plain_ms = cuda_ms(lambda: lc.laplace_from_stats_torch(S, C, levels, pp, pc),
                       reps=5, warmup=1)
    candidates, hist = laplace_trips(S, C, levels, pp, pc, what)
    n_pp, n_pc = args[-2:]
    nbytes = 4 * (2 * L * P1 + P1 + 2 * n_pp + 4 * n_pc + 2 * L + 4 * L)
    # the work these inputs need: per lane one direction a Newton step,
    # the objective at the prior, and the candidate objectives up to the
    # first acceptance of each step
    ops = OPS_PER_BUCKET * P1 * (L * lc.NEWTON_STEPS + L + candidates)
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F64_FLOPS) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S > ops / PEAK_F64_FLOPS
                else "operations")
    log(f"{what}: Laplace kernel {ms:.5f} ms device (CUDA graph), "
        f"{call:.5f} ms a wrapper call, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.6f} ms ({nbytes} B, {ops:.3e} FP64 operations: "
        f"{candidates} candidate objectives), {bound_ms / ms:.2%} of the "
        "bound")
    return dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms, armijo_j=hist)


def check_blocked(a, block, what):
    """The cluster sweep at ``block`` rows a step against its plain
    version on the inputs ``a``, as phase 3 holds it at 8: rtol 1e-4 /
    atol 1e-5 with the gate off, at most 0.5% of the gate decisions
    differing with it on, the CTAs of the cluster agreeing; then its
    time (CUDA events, median of 20), the plain version's and the byte
    bound."""
    import torch
    from circuitmap_torch.ops import sweep_cuda as sc

    n, k = a["stim"].shape
    P = a["powers"].shape[0]
    kw = dict(block_size=block)
    ker = sweep_call(sc.sweep_spikes_blocked, a, 0, **kw)
    plain = sweep_call(sc.sweep_spikes_blocked_torch, a, 0, **kw)
    torch.cuda.synchronize()
    err = (ker - plain).abs().max().item()
    ok = torch.allclose(ker, plain, rtol=1e-4, atol=1e-5)
    ker1 = sweep_call(sc.sweep_spikes_blocked, a, 1, **kw)
    plain1 = sweep_call(sc.sweep_spikes_blocked_torch, a, 1, **kw)
    off_k = (ker1.sum(1) == 0) & (ker.sum(1) > 0)
    off_p = (plain1.sum(1) == 0) & (plain.sum(1) > 0)
    flips = int((off_k != off_p).sum())
    log(f"{what}: gate off max |kernel - plain| = {err:.3e}; gate on "
        f"{int(off_k.sum())} rows gated off, {flips} decisions differ")
    if not ok:
        raise AssertionError(f"{what}: the sweep kernel disagrees with its "
                             "plain version beyond rtol 1e-4 / atol 1e-5")
    if flips > 0.005 * n:
        raise AssertionError(f"{what}: {flips} gate decisions differ "
                             "(> 0.5% of rows)")
    check_cta_agreement(ker1, plain1, a, block, what)
    ms = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked, a, 1, **kw))
    plain_ms = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked_torch, a,
                                          1, **kw), reps=3, warmup=1)
    bound_ms = 3 * n * k * 4 / PEAK_BYTES_PER_S * 1e3
    plan = sc.launch_plan(1, k, sc.sub_steps(block)[1], P)
    log(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, byte bound "
        f"{bound_ms:.4f} ms ({bound_ms / ms:.1%}); plan {plan}")
    return dict(rows_per_step=block, P=P, max_abs_err=err, gate_flips=flips,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_share=bound_ms / ms, on_chip=plan.on_chip,
                ring_depth=plan.depth)


WIDE_POWERS = tuple(float(p) for p in np.linspace(30.0, 75.0, 16))


def phase_blocks_and_levels():
    """Phase 3b: the sweep at every pinned block size the JAX package's
    frontier study fitted beside 8 (7, 12, 16, 32; P=3) and at 16 power
    levels (8 rows and one row a step), and the Laplace kernel at 17
    buckets, each against its plain version."""
    from circuitmap_torch.ops import sweep_cuda as sc
    from circuitmap_torch.ops import sweep_row_cuda as sr
    from circuitmap_torch.solvers._laplace import powercurve_stats

    log("phase 3b: cluster sweep at pinned blocks 7, 12, 16, 32 (P=3) and "
        "at 16 power levels; Laplace at 17 buckets (N=1000, K=20000)")
    blocks = {}
    for block in (7, 12, 16, 32):
        blocks[block] = check_blocked(sweep_inputs(seed=block, block=block),
                                      block, f"{block} rows a step, P=3")
    a16 = sweep_inputs(seed=16, powers=WIDE_POWERS)
    wide = check_blocked(a16, 8, "8 rows a step, P=16")
    row16, _ = check_sweep_kernel(sr.sweep_spikes_row,
                                  sr.sweep_spikes_row_torch, a16,
                                  "one row a step, P=16")
    lam = sweep_call(sc.sweep_spikes_blocked_torch, a16, 1)
    S, C, levels = powercurve_stats(lam, a16["stim"], a16["powers"],
                                    total_trials=K,
                                    counts=a16["power_counts"])
    lap17 = check_laplace(S, C, levels, "N=1000, P+1=17")
    return dict(blocks=blocks, sweep_p16=wide, row_p16_max_abs_err=row16,
                laplace_p17=lap17)


def phase_laplace(sweep_state):
    from circuitmap_torch.solvers._laplace import powercurve_stats

    log("phase 4: Laplace kernel vs plain version (N=1000, P+1=4)")
    a, lam = sweep_state
    S, C, levels = powercurve_stats(lam, a["stim"], a["powers"],
                                    total_trials=K, counts=a["power_counts"])
    return dict(name="laplace", route="cuda",
                source="circuitmap_torch/csrc/laplace.cu",
                replaces="circuitmap_tpu/ops/laplace_pallas.py:149",
                library_ms=None, **check_laplace(S, C, levels, "N=1000"))


def phase_main_path():
    import torch
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.ops.laplace_cuda import laplace_from_stats
    from circuitmap_torch.ops.resize_cuda import relu_resize_cat
    from circuitmap_torch.ops.sweep_cuda import sweep_spikes_blocked
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 5: main path (simulate N=1000 K=20000, int4d2 demix, "
        "50-iteration CAVIaR)")
    t0 = time.time()
    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=H, connection_prob=0.05, batch_size=1000,
                   verbose=False)
    log(f"simulate: {time.time() - t0:.2f} s")
    demixer = NeuralDemixer(str(CHECKPOINT))
    opts = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS), "verbose": False}

    def pipeline():
        dem = demixer(sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
                      verbose=False)
        return dem, Model(N).fit(dem, sim["stim_matrix"], method="caviar",
                                 fit_options=dict(opts))

    reset_counts()
    t0 = time.time()
    dem, model = pipeline()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"sweep_blocked": sweep_spikes_blocked.launches,
                "laplace": laplace_from_stats.launches,
                "relu_resize_cat": relu_resize_cat.launches}
    by_path = kernel_launches(read_counts())
    r2 = r2_score(sim["weights"], model.state["mu"])
    log(f"first run {first_s:.3f} s; launches {launches}; truth-R2 {r2:.4f}")
    for key in ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"):
        if np.isnan(np.asarray(model.state[key])).any():
            raise AssertionError(f"posterior {key} holds a NaN")
    if dem.shape != (K, 900) or not torch.isfinite(dem).all():
        raise AssertionError("demixed traces are not finite [K, 900]")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched on the main path: {launches}")
    if launches["relu_resize_cat"] != 4 * -(-K // DEMIX_CHUNK):
        raise AssertionError("the demix must launch the epilogue kernel four "
                             f"times a {DEMIX_CHUNK}-row chunk: {launches}")
    if r2 < 0.98:
        raise AssertionError(f"truth-R2 {r2:.4f} < 0.98")

    e2e, fit_only = [], []
    for _ in range(3):
        t0 = time.time()
        pipeline()
        torch.cuda.synchronize()
        e2e.append(time.time() - t0)
    for _ in range(3):
        t0 = time.time()
        Model(N).fit(dem, sim["stim_matrix"], method="caviar",
                     fit_options=dict(opts))
        torch.cuda.synchronize()
        fit_only.append(time.time() - t0)
    log(f"end-to-end (demix + fit) median of 3 warm runs: "
        f"{statistics.median(e2e):.4f} s {e2e}")
    log(f"fit-only median of 3 warm runs: {statistics.median(fit_only):.4f} s "
        f"{fit_only}")
    log(f"truth-R2 {r2:.6f} (JAX package on this data: 0.9968)")
    return (by_path, sim, dem, model, statistics.median(e2e),
            statistics.median(fit_only))


def profiled(fn, label):
    """``fn()`` under torch.profiler (CPU and CUDA activities), inside a
    ``label`` annotation, synchronised: logs the wall span, the device's
    busy time and idle share (1 - the union of device intervals / the
    span) and the 10 device operations with the most total time. Returns
    the device rows of ``key_averages()``, None where the profiler saw
    no device time; ``profiled.last`` keeps the wall and busy ms and the
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the annotation shows on the device's timeline too: not device work
    span = next(e.time_range for e in events
                if e.name == label and e.device_type != cuda)
    on_device = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == cuda and e.name != label)
    if not on_device:
        log(f"{label}: the profiler recorded no device time: top operations "
            "and idle share not measured")
        return None
    busy, cur_s, cur_e = 0.0, *on_device[0]
    for s, e in on_device[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    fit_us = span.end - span.start
    profiled.last = dict(wall_ms=fit_us / 1e3, busy_ms=busy / 1e3,
                         idle=1 - busy / fit_us)
    rows = [a for a in prof.key_averages()
            if a.device_type == cuda and a.key != label]
    rows.sort(key=lambda a: a.self_device_time_total, reverse=True)
    log(f"{label}: {fit_us / 1e3:.3f} ms wall, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / fit_us:.4f}; device "
        f"total {sum(a.self_device_time_total for a in rows) / 1e3:.3f} ms; "
        f"{sum(a.count for a in rows)} device operations")
    for a in rows[:10]:
        log(f"  {a.self_device_time_total / 1e3:10.3f} ms {a.count:7d} calls  "
            f"{a.key[:90]}")
    return rows


def phase_profile(sim, dem):
    """One warm main-path fit under torch.profiler (``profiled``): the
    top device operations, the Laplace kernel's total and the device's
    idle share. Then the Laplace trip counts on the statistics of the
    fit's last refit (its final lam through ``powercurve_stats``).
    Returns the Laplace total in ms, None where the profiler saw no
    device time."""
    import torch
    from circuitmap_torch import Model, default_priors
    from circuitmap_torch.solvers._laplace import powercurve_stats

    log("phase 5b: one warm main-path fit under torch.profiler; the "
        "Laplace kernel's Armijo trips on the fit's own statistics")
    opts = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
            "verbose": False}
    fitted = []
    rows = profiled(lambda: fitted.append(Model(N).fit(
        dem, sim["stim_matrix"], method="caviar", fit_options=dict(opts))),
        "main_path_fit")
    laplace_ms = None
    if rows is not None:
        laplace_ms = sum(a.self_device_time_total for a in rows
                         if "laplace_kernel" in a.key) / 1e3
        log(f"profiled fit: Laplace kernel total {laplace_ms:.4f} ms")
    lam = torch.from_numpy(np.asarray(fitted[0].state["lam"])).cuda()
    stim = torch.from_numpy(np.asarray(sim["stim_matrix"], np.float32)).cuda()
    powers = torch.tensor(POWERS, device="cuda")
    counts = torch.stack([(stim == p).sum(1) for p in POWERS], 1).float()
    S, C, levels = powercurve_stats(lam, stim, powers, total_trials=K,
                                    counts=counts)
    p = default_priors(N)
    laplace_trips(S, C, levels, torch.from_numpy(p["phi"]).float().cuda(),
                  torch.from_numpy(p["phi_cov"]).float().cuda(),
                  "main-path statistics (the fit's last refit)")
    return laplace_ms


def row_call(fn, a, gate, msrmp=0.35, sig=0.1, dtype=None, rows="order"):
    """``fn`` on the sweep inputs ``a``; ``rows`` names the visiting
    order it takes (``order`` for the row kernel, ``border`` for the
    blocked one)."""
    t = {k: (v.to(dtype) if dtype is not None and v.is_floating_point() else v)
         for k, v in a.items()}
    if dtype is not None and hasattr(msrmp, "to"):
        sig, msrmp = sig.to(dtype), msrmp.to(dtype)
    return fn(t["y"], t["stim"], t["mu"], t["beta"], t["lam"], sig,
              t["m0"], t["m1"], t["lam_mask"], t["powers"], t["power_counts"],
              t[rows], msrmp, 3.0, float(gate))


def check_sweep_kernel(fn, plain_fn, a, what, **kw):
    """A sweep kernel against its plain version on the same inputs, as
    phase 3 holds the blocked kernel: rtol 1e-4 / atol 1e-5 with the
    gate off; with it on, at most 0.5% of the gate decisions may differ
    (a borderline iso >= msrmp can flip under another reduction order).
    The distances of both from the plain version run in float64 are
    printed beside. Returns (the largest |kernel - plain| with the gate
    off, the kernel's output with it on)."""
    import torch

    ker = row_call(fn, a, 0, **kw)
    plain = row_call(plain_fn, a, 0, **kw)
    exact = row_call(plain_fn, a, 0, dtype=torch.float64, **kw)
    err = (ker - plain).abs().max().item()
    err_k = (ker.double() - exact).abs().max().item()
    err_p = (plain.double() - exact).abs().max().item()
    log(f"{what}, gate off: max |kernel - plain| = {err:.3e}; vs float64 "
        f"plain: kernel {err_k:.3e}, f32 plain {err_p:.3e}")
    if not torch.allclose(ker, plain, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             "version beyond rtol 1e-4 / atol 1e-5 (gate "
                             "off)")
    ker1 = row_call(fn, a, 1, **kw)
    plain1 = row_call(plain_fn, a, 1, **kw)
    off_k = (ker1.sum(-1) == 0) & (ker.sum(-1) > 0)
    off_p = (plain1.sum(-1) == 0) & (plain.sum(-1) > 0)
    flips = int((off_k != off_p).sum())
    log(f"{what}, gate on: {int(off_k.sum())} rows gated off; {flips} gate "
        f"decisions differ from the plain version")
    if flips > 0.005 * off_k.numel():
        raise AssertionError(f"{what}: {flips} gate decisions differ "
                             "(> 0.5% of rows)")
    check_cta_agreement(ker1, plain1, a,
                        8 if kw.get("rows") == "border" else 1,
                        f"{what}, gate on")
    return err, ker1


def stack_inputs(parts):
    """Per-experiment sweep inputs stacked on a leading axis, the trial
    axis padded to the largest K with inert columns (zero charge, stim,
    spikes and mask), as a ragged ``caviar_many`` pads; powers shared."""
    import torch
    import torch.nn.functional as F

    kp = max(p["y"].shape[-1] for p in parts)
    out = {}
    for key in parts[0]:
        if key in ("y", "stim", "lam", "lam_mask"):
            out[key] = torch.stack([F.pad(p[key], (0, kp - p[key].shape[-1]))
                                    for p in parts])
        else:
            out[key] = torch.stack([p[key] for p in parts])
    out["powers"] = parts[0]["powers"]
    return out


def per_expt(*values):
    import torch

    return torch.tensor(values, device="cuda")


def phase_row_sweep():
    from circuitmap_torch.ops import sweep_cuda as sc
    from circuitmap_torch.ops import sweep_row_cuda as sr

    log("phase 6: cluster sweep at one row a step vs plain version (P=3: "
        "N=1000 K=20000; E=4 at K=15000; N=200 at K=100000 at 1 and 8 rows "
        "a step; N=16 at K=300000, r off chip)")
    a = sweep_inputs(seed=1)
    err, _ = check_sweep_kernel(sr.sweep_spikes_row, sr.sweep_spikes_row_torch,
                                a, "E=1 N=1000 K=20000")
    ms = cuda_ms(lambda: row_call(sr.sweep_spikes_row, a, 1))
    plain_ms = cuda_ms(lambda: row_call(sr.sweep_spikes_row_torch, a, 1),
                       reps=3, warmup=1)
    bound_ms = 3 * N * K * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"row kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, byte bound "
        f"{bound_ms:.4f} ms (3*N*K*4 B at 3.35 TB/s), "
        f"{bound_ms / ms:.1%} of the bound")

    E, KE = 4, 15000
    b = stack_inputs([sweep_inputs(seed=10 + e, k=KE) for e in range(E)])
    kw = dict(msrmp=per_expt(0.3, 0.35, 0.4, 0.45),
              sig=per_expt(0.1, 0.12, 0.09, 0.11))
    err_e4, _ = check_sweep_kernel(sr.sweep_spikes_row_batched,
                                   sr.sweep_spikes_row_batched_torch, b,
                                   f"E={E} N=1000 K={KE}", **kw)
    ms_e4 = cuda_ms(lambda: row_call(sr.sweep_spikes_row_batched, b, 1, **kw))
    plain_ms_e4 = cuda_ms(
        lambda: row_call(sr.sweep_spikes_row_batched_torch, b, 1, **kw),
        reps=3, warmup=1)
    bound_ms_e4 = 3 * E * N * KE * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"batched row kernel (E={E}) {ms_e4:.4f} ms, plain "
        f"{plain_ms_e4:.3f} ms, byte bound {bound_ms_e4:.4f} ms, "
        f"{bound_ms_e4 / ms_e4:.1%} of the bound")
    del b

    big = sweep_inputs(seed=2, n=200, k=100000)
    for fn, plain_fn, rows in (
            (sr.sweep_spikes_row, sr.sweep_spikes_row_torch, "order"),
            (sc.sweep_spikes_blocked, sc.sweep_spikes_blocked_torch,
             "border")):
        check_sweep_kernel(fn, plain_fn, big,
                           f"{'1 row' if rows == 'order' else '8 rows'} a "
                           "step, E=1 N=200 K=100000 (past the old kernels' "
                           "K limit)", rows=rows)
    del big

    # one row a step past the widest slice r, y, mask and est keep on
    # chip: r in device memory, the ring one step deep
    n, k = 16, 300000
    plan = sc.launch_plan(1, k, 1, len(POWERS))
    log(f"one row a step at N={n} K={k}: {plan}")
    if plan.on_chip or plan.depth < 1:
        raise AssertionError(f"K={k} at one row a step must keep r off chip "
                             f"with a ring of at least one step: {plan}")
    wide = sweep_inputs(seed=3, n=n, k=k)
    check_sweep_kernel(sr.sweep_spikes_row, sr.sweep_spikes_row_torch, wide,
                       f"1 row a step, E=1 N={n} K={k} (r off chip)")
    del wide
    return dict(name="sweep_row", route="cuda",
                source="circuitmap_torch/csrc/sweep_cluster.cuh",
                replaces="circuitmap_tpu/ops/sweep_pallas.py:338, :89, :481",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes", library_ms=None,
                bound_share=bound_ms / ms, rows_per_step=1,
                **cluster_fields(1, K, 1),
                batched=dict(E=E, K=KE, max_abs_err=err_e4, ms=ms_e4,
                             plain_ms=plain_ms_e4, bound_ms=bound_ms_e4,
                             bound_share=bound_ms_e4 / ms_e4,
                             **cluster_fields(E, KE, 1)))


RAGGED = tuple(K * m // 10 for m in (9, 8, 7, 6))  # 18000 .. 12000 trials


def phase_batched_kernels():
    """The batched blocked sweep and the batched Laplace refit at the
    ragged stack's shapes: E=4 experiments of RAGGED trials padded to
    the largest, per-experiment sig and msrmp_eff; then the bucket
    statistics of its output with each experiment's true trial count
    through the Laplace kernel at [4, 1000] lanes."""
    import torch
    from circuitmap_torch.ops import sweep_cuda as sc
    from circuitmap_torch.solvers._laplace import powercurve_stats

    E, kp = len(RAGGED), max(RAGGED)
    log(f"phase 7: batched cluster sweep at 8 rows a step (E={E}, N={N}, {RAGGED} trials "
        f"padded to {kp}, P=3) and batched Laplace ([{E}, {N}] lanes) vs "
        "plain versions")
    b = stack_inputs([sweep_inputs(seed=20 + e, k=k)
                      for e, k in enumerate(RAGGED)])
    kw = dict(msrmp=per_expt(0.3, 0.35, 0.4, 0.45),
              sig=per_expt(0.1, 0.12, 0.09, 0.11), rows="border")
    what = f"blocked E={E} ragged"
    err, lam1 = check_sweep_kernel(sc.sweep_spikes_blocked_batched,
                                   sc.sweep_spikes_blocked_batched_torch, b,
                                   what, **kw)
    padded = torch.arange(kp, device="cuda") >= per_expt(*RAGGED)[:, None]
    pad_max = (lam1.abs() * padded[:, None, :]).max().item()
    log(f"{what}: largest |lam| in the padded columns {pad_max:.3e}")
    if pad_max != 0.0:
        raise AssertionError(f"{what}: padded columns are not inert")
    ms = cuda_ms(lambda: row_call(sc.sweep_spikes_blocked_batched, b, 1, **kw))
    plain_ms = cuda_ms(
        lambda: row_call(sc.sweep_spikes_blocked_batched_torch, b, 1, **kw),
        reps=3, warmup=1)
    bound_ms = 3 * E * N * kp * 4 / PEAK_BYTES_PER_S * 1e3
    log(f"{what}: batched blocked kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, byte bound {bound_ms:.4f} ms (3*E*N*{kp}*4 B "
        f"at 3.35 TB/s), {bound_ms / ms:.1%} of the bound")
    sweep_batched = dict(E=E, K=list(RAGGED), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_share=bound_ms / ms,
                         **cluster_fields(E, kp, 8))

    S, C, levels = powercurve_stats(
        lam1, b["stim"], b["powers"], total_trials=per_expt(*RAGGED),
        counts=b["power_counts"])
    laplace_batched = dict(lanes=[E, N], **check_laplace(
        S, C, levels, f"[{E}, {N}] lanes"))
    del b, lam1
    torch.cuda.synchronize()
    return sweep_batched, laplace_batched


def timed(fn):
    import torch

    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def phase_block1_fit(sim, dem):
    from circuitmap_torch import Model
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 8: strictly sequential fit (sweep_block_size=1, 50 "
        "iterations) on the demixed traces")
    opts = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
            "verbose": False, "sweep_block_size": 1}

    def fit():
        return Model(N).fit(dem, sim["stim_matrix"], method="caviar",
                            fit_options=dict(opts))

    reset_counts()
    model, first_s = timed(fit)
    launches = kernel_launches(read_counts())
    r2 = r2_score(sim["weights"], model.state["mu"])
    log(f"first run {first_s:.3f} s; launches {launches}; truth-R2 {r2:.4f}")
    if launches["sweep_row"] != 50 or launches["sweep_blocked"] != 0:
        raise AssertionError(f"the block-1 fit must launch the row kernel "
                             f"50 times and nothing else: {launches}")
    if np.isnan(model.state["mu"]).any() or r2 < 0.98:
        raise AssertionError(f"block-1 fit: truth-R2 {r2:.4f} < 0.98 or NaN")
    fit_only = [timed(fit)[1] for _ in range(3)]
    log(f"block-1 fit-only median of 3 warm runs: "
        f"{statistics.median(fit_only):.4f} s {fit_only}")
    return launches


def phase_large_k_fit():
    """An "auto" fit past the old blocked kernel's shared-memory limit
    (K = 56,064), on the main path's pipeline (int4d2 demix, 50
    iterations): the cluster kernel takes any K, so "auto" must launch it
    at 8 rows a step once an iteration and never at one row."""
    import torch
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.utils.metrics import r2_score

    n, k, iters = 200, 60000, 50
    log(f"phase 9: sweep_block_size='auto' at K={k} (past the old blocked "
        f"kernel's limit of 56064): simulate N={n} K={k}, int4d2 demix, "
        f"{iters}-iteration fit")
    np.random.seed(1)
    sim = simulate(N=n, trials=k, H=H, connection_prob=0.05,
                   batch_size=1000, verbose=False)
    dem = NeuralDemixer(str(CHECKPOINT))(
        sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
        verbose=False)
    torch.cuda.synchronize()
    reset_counts()
    model, fit_s = timed(lambda: Model(n).fit(
        dem, sim["stim_matrix"], method="caviar",
        fit_options={"iters": iters, "msrmp": 0.3, "powers": list(POWERS),
                     "verbose": False}))
    launches = kernel_launches(read_counts())
    w, mu = sim["weights"], model.state["mu"]
    r2 = r2_score(w, mu)
    miss = int(np.argmax(np.abs(mu - w)))
    log(f"fit {fit_s:.3f} s; launches {launches}; truth-R2 {r2:.4f}; "
        f"largest miss cell {miss}: mu {mu[miss]:.2f} vs w {w[miss]:.2f}")
    if launches["sweep_blocked"] != iters or launches["sweep_row"] != 0:
        raise AssertionError(f"'auto' at K={k} must launch the blocked "
                             f"sweep {iters} times and the row sweep never: "
                             f"{launches}")
    if np.isnan(mu).any() or r2 < 0.95:
        raise AssertionError(f"K={k} fit: truth-R2 {r2:.4f} < 0.95 or NaN")
    return launches


def fold_r2(sim, results, what):
    """Truth-R2 of every fold and the cell of each fold's largest miss;
    fails on a NaN outside beta (NaN there marks a cell reconnected from
    one event)."""
    from circuitmap_torch.utils.metrics import r2_score

    w = sim["weights"]
    r2s = [r2_score(w, r["mu"]) for r in results]
    log(f"{what}: truth-R2 per fold " + ", ".join(f"{v:.4f}" for v in r2s)
        + f"; mean {np.mean(r2s):.4f}")
    misses = [int(np.argmax(np.abs(r["mu"] - w))) for r in results]
    log(f"{what}: largest miss per fold (cell: mu vs w) " + ", ".join(
        f"{n}: {r['mu'][n]:.2f} vs {w[n]:.2f}"
        for n, r in zip(misses, results)))
    for r in results:
        for key, v in r.items():
            if np.isnan(np.asarray(v)).any() and key != "beta":
                raise AssertionError(f"{what}: posterior {key} holds a NaN")
    return r2s, misses


FOLD_FLOOR = 0.95


def require_floor(r2s, what, excused=()):
    """Every fold at FOLD_FLOOR or more, but for the folds in
    ``excused``, whose drop the plain float64 sweep reproduced."""
    low = [f for f, v in enumerate(r2s) if v < FOLD_FLOOR and f not in excused]
    if low:
        raise AssertionError(f"{what}: truth-R2 below {FOLD_FLOOR} on folds "
                             f"{low}: {[round(r2s[f], 4) for f in low]}")


def witness_plain64(sim, ys, stims, args, kw, fold, kernel_fit, cell):
    """Refit one fold as ``caviar_many`` fits it at block 1 (the single
    fit's loop, seed = the fold's index), with the row kernel swapped for
    its plain version run in float64, on the same card and the same
    random streams (the sweep draws none). The fold's low truth-R2 is
    the strictly sequential schedule's, not the kernel's reduction
    order, when that fit leaves the cell of the kernel fit's largest
    miss connected or not as the kernel fit (``kernel_fit``) did and
    scores within 0.01 of it. Returns whether it does."""
    import importlib

    import torch
    from circuitmap_torch import caviar_many
    from circuitmap_torch.ops.sweep_row_cuda import sweep_spikes_row_torch
    from circuitmap_torch.utils.metrics import r2_score

    cav = importlib.import_module("circuitmap_torch.solvers.caviar")

    def plain64(*a):
        wide = [x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in a]
        return sweep_spikes_row_torch(*wide).float()

    key = (True, False)  # the single fit's block-1 sweep
    kernel_sweep, cav._SWEEPS[key] = cav._SWEEPS[key], plain64
    try:
        (res,), fit_s = timed(lambda: caviar_many(
            ys[fold:fold + 1], stims[fold:fold + 1], *args, seeds=[fold],
            compile_mode="sequential", sweep_block_size=1, **kw))
    finally:
        cav._SWEEPS[key] = kernel_sweep
    r2 = r2_score(sim["weights"], res["mu"])
    r2_kernel = r2_score(sim["weights"], kernel_fit["mu"])
    same = ((res["mu"][cell] == 0.0) == (kernel_fit["mu"][cell] == 0.0)
            and abs(r2 - r2_kernel) < 0.01)
    log(f"fold {fold}: the plain row sweep in float64 ({fit_s:.1f} s) "
        f"scores truth-R2 {r2:.4f} (kernel {r2_kernel:.4f}); cell {cell} at "
        f"mu {res['mu'][cell]:.2f} (kernel {kernel_fit['mu'][cell]:.2f}) "
        f"against w {sim['weights'][cell]:.2f}: "
        f"{'the same drop' if same else 'NOT the same drop'}")
    return same


def phase_many(sim, dem):
    """caviar_many on 4 folds. The batched run (auto: block 1) must equal
    the same folds fit one by one through the single fit's loop at block
    1 with the same seeds. Every fold must reach truth-R2 0.95, but a
    block-1 fold whose drop the plain row sweep in float64 reproduces
    (the strictly sequential schedule can gate a strong cell off for
    good at some seeds)."""
    import torch
    from circuitmap_torch import caviar_many, default_priors

    log("phase 10: caviar_many on 4 cross-validation folds (each holds out "
        "one quarter of the trials: [4, 15000, 900] device traces, "
        "[4, 1000, 15000] stims), 50 iterations")
    q = K // 4
    keeps = [np.r_[0:f * q, (f + 1) * q:K] for f in range(4)]
    ys = torch.stack([dem[torch.from_numpy(kp).cuda()] for kp in keeps])
    stims = np.stack([sim["stim_matrix"][:, kp] for kp in keeps])
    p = default_priors(N)
    args = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=50, msrmp=0.3, powers=list(POWERS), verbose=False)
    paths = {}

    def many(**opts):
        return timed(lambda: caviar_many(ys, stims, *args, **kw, **opts))

    reset_counts()
    batched, first_s = many(compile_mode="batched")
    paths["many_batched"] = launches = kernel_launches(read_counts())
    counts = read_counts()
    log(f"batched (auto: block 1) first run {first_s:.3f} s; launches "
        f"{counts}")
    if counts["sweep_spikes_row_batched"] != 50 or launches["laplace"] < 50:
        raise AssertionError("the batched fit must launch the batched row "
                             "kernel 50 times and the Laplace kernel at "
                             f"least 50 times: {counts}")
    r2s, misses = fold_r2(sim, batched, "batched")
    excused = [f for f, v in enumerate(r2s) if v < FOLD_FLOOR and
               witness_plain64(sim, ys, stims, args, kw, f, batched[f],
                               misses[f])]
    require_floor(r2s, "batched", excused)
    warm = [many(compile_mode="batched")[1] for _ in range(3)]
    log(f"batched caviar_many, 4 folds, median of 3 warm runs: "
        f"{statistics.median(warm):.4f} s {warm}")

    reset_counts()
    seq1, seq1_s = many(compile_mode="sequential", sweep_block_size=1)
    paths["many_sequential_block1"] = kernel_launches(read_counts())
    log(f"sequential at block 1 one run {seq1_s:.3f} s; launches "
        f"{read_counts()}")
    require_floor(fold_r2(sim, seq1, "sequential block 1")[0],
                  "sequential block 1", excused)
    for f, (a, b) in enumerate(zip(batched, seq1)):
        d = float(np.abs(a["mu"] - b["mu"]).max())
        if d > 1e-3 or not np.array_equal(a["mu"] != 0, b["mu"] != 0):
            raise AssertionError(f"fold {f}: batched and sequential block-1 "
                                 f"fits differ (max |d mu| {d:.3e})")
    log("batched == sequential at block 1 on every fold (max |d mu| "
        + ", ".join(f"{np.abs(a['mu'] - b['mu']).max():.2e}"
                    for a, b in zip(batched, seq1)) + ")")

    reset_counts()
    res, seq_s = many(compile_mode="sequential")
    paths["many_sequential"] = kernel_launches(read_counts())
    log(f"sequential (auto: block 8) one run {seq_s:.3f} s; launches "
        f"{read_counts()}")
    if paths["many_sequential"]["sweep_blocked"] != 200:
        raise AssertionError("the sequential fits must launch the blocked "
                             "kernel 4 x 50 times")
    require_floor(fold_r2(sim, res, "sequential block 8")[0],
                  "sequential block 8")
    del ys, res, batched, seq1

    log(f"phase 11: ragged caviar_many, 4 folds of {RAGGED} trials, "
        "sweep_block_size=8, batched")
    host = dem.cpu().numpy()
    idx = [(np.arange(k) + K // 10 * f) % K for f, k in enumerate(RAGGED)]
    reset_counts()
    res, rag_s = timed(lambda: caviar_many(
        [host[i] for i in idx], [sim["stim_matrix"][:, i] for i in idx],
        *args, compile_mode="batched", sweep_block_size=8, **kw))
    paths["many_ragged"] = kernel_launches(read_counts())
    counts = read_counts()
    log(f"ragged batched (block 8) one run {rag_s:.3f} s; launches {counts}")
    if counts["sweep_spikes_blocked_batched"] != 50:
        raise AssertionError("the ragged batched fit must launch the "
                             f"batched blocked kernel 50 times: {counts}")
    if tuple(r["lam"].shape[1] for r in res) != RAGGED:
        raise AssertionError("ragged results must come back at each "
                             "fold's true width")
    require_floor(fold_r2(sim, res, "ragged")[0], "ragged")
    return paths


def phase_solver_mappings():
    """B3 (the cluster kernel at one row a step) at the arguments the
    CAVI-SnS and MBCS-ARD sweeps give it, held against its plain version
    as phase 6 holds it (``check_sweep_kernel``: gate off, gate on, the
    gates of a cluster's CTAs) on the main path's sweep inputs: SnS
    with the weights mu*alpha and the slab scale beta_eff of
    ``cavi_sns.row_sweep_weights`` and the threshold -1 (its gate-on
    case is the solver's); ARD with the power-curve means (0, -logit)
    and one power level (its gate-off case is the solver's)."""
    import torch
    from circuitmap_torch.ops import sweep_row_cuda as sr
    from circuitmap_torch.solvers.cavi_sns import row_sweep_weights

    log("phase 12: the row kernel at the CAVI-SnS and MBCS-ARD arguments "
        f"vs plain version (N={N}, K={K})")
    a = sweep_inputs(seed=5)
    alpha = torch.from_numpy(np.random.default_rng(5).uniform(
        0.05, 1.0, N).astype(np.float32)).cuda()
    w, beta_eff = row_sweep_weights(a["mu"], a["beta"], alpha)
    sns = dict(a, mu=w, beta=beta_eff)
    logit = float(np.log(0.75 / 0.25))
    ard = dict(a, m0=torch.zeros_like(a["m0"]),
               m1=torch.full_like(a["m1"], -logit), powers=a["powers"][-1:],
               power_counts=a["power_counts"][:, -1:])
    out = {}
    for name, inputs, kw in (("sns", sns, dict(msrmp=-1.0)),
                             ("ard", ard, {})):
        err, _ = check_sweep_kernel(sr.sweep_spikes_row,
                                    sr.sweep_spikes_row_torch, inputs,
                                    f"{name} arguments", **kw)
        gate = 1 if name == "sns" else 0
        ms = cuda_ms(lambda: row_call(sr.sweep_spikes_row, inputs, gate, **kw))
        log(f"{name} arguments: row kernel {ms:.4f} ms (gate "
            f"{'on' if gate else 'off'})")
        out[name] = dict(max_abs_err=err, ms=ms)
    return out


# cut for the call's time (PERF.md §4): the SnS float64 witness (was 50
# iterations, then 20; 5 by choice: it holds B3 against the float64 plain
# sweep on the first 5 sweep inputs of the fit, ~1.4 s of the call an
# iteration), the profiled SnS fit
# (was 10; ~16,000 launches an iteration, and the profiler takes ~1 ms of
# host time per device operation to process) and the SnS parts of
# sns_many (was 10, then 5; 3 since phase 28 came)
SNS_WITNESS_ITERS = 5
SNS_PROFILE_ITERS = 2
SNS_MANY_ITERS = 3


def phase_sns(sim, dem):
    """CAVI-SnS through ``Model.fit`` with its defaults (random order,
    100 Monte Carlo samples), 50 iterations without histories, warmed up
    by a 2-iteration fit under the profiler: B3 and B2 once an
    iteration each; truth-R2 of mu*alpha and of mu. Then the float64
    witness: the same fit, cut to its first SNS_WITNESS_ITERS (5)
    iterations for the call's time, with the lam sweep swapped for its
    plain version in float64, on the same card and random streams (the
    sweep draws none), and on each of its sweeps the kernel held against
    that plain version on the same inputs: at most 0.5% of the gate decisions may differ, and a sweep
    with none differing must agree to 1e-4. The two fits' truth-R2 are
    printed, not compared: the SnS gate is absorbing (a row it zeroes
    stays zero), so one decision at the spike-count threshold that falls
    the other way under a rounding sends the two fits apart for good."""
    import importlib

    import torch
    from circuitmap_torch import Model
    from circuitmap_torch.ops.sweep_row_cuda import sweep_spikes_row_torch
    from circuitmap_torch.utils.metrics import r2_score

    sns_mod = importlib.import_module("circuitmap_torch.solvers.cavi_sns")
    log("phase 13: CAVI-SnS, 50 iterations, Model.fit defaults, on the "
        "demixed traces")
    w = sim["weights"]

    def fit(**extra):
        return Model(N).fit(dem, sim["stim_matrix"], method="cavi_sns",
                            fit_options={"iters": 50, "verbose": False,
                                         **extra})

    profiled(lambda: fit(iters=SNS_PROFILE_ITERS, save_histories=False),
             f"sns_fit_{SNS_PROFILE_ITERS}_iterations")
    reset_counts()
    model, warm_s = timed(lambda: fit(save_histories=False))
    launches = kernel_launches(read_counts())
    mu, alpha = model.state["mu"], model.state["alpha"]
    r2_w, r2_mu = r2_score(w, mu * alpha), r2_score(w, mu)
    log(f"warm fit {warm_s:.3f} s (no histories); launches {launches}; "
        f"truth-R2 of mu*alpha {r2_w:.4f}, of mu {r2_mu:.4f}; "
        f"{int((alpha > 0.5).sum())} cells at alpha > 0.5 "
        f"({int((w != 0).sum())} connected)")
    if launches != launch_dict(0, 50, 50):
        raise AssertionError("a 50-iteration SnS fit must launch the row "
                             f"kernel and the Laplace kernel 50 times each: "
                             f"{launches}")
    for key in ("mu", "beta", "alpha", "lam", "shape", "rate", "phi",
                "phi_cov"):
        if np.isnan(np.asarray(model.state[key])).any():
            raise AssertionError(f"SnS posterior {key} holds a NaN")
    del model

    kernel_sweep = sns_mod.sweep_spikes_row
    held = []

    def plain64(*args):
        wide = [x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in args]
        plain = sweep_spikes_row_torch(*wide)
        ker = kernel_sweep(*args)
        off_k, off_p = ker.sum(-1) == 0, plain.sum(-1) == 0
        flips = int((off_k != off_p).sum())
        err = (ker.double() - plain).abs().max().item()
        held.append((flips, err, int(off_p.sum())))
        return plain.float()

    sns_mod.sweep_spikes_row = plain64
    try:
        witness, wit_s = timed(lambda: fit(iters=SNS_WITNESS_ITERS,
                                           save_histories=False))
    finally:
        sns_mod.sweep_spikes_row = kernel_sweep
    r2_wit = r2_score(w, witness.state["mu"] * witness.state["alpha"])
    flips = [h[0] for h in held]
    clean = [h[1] for h in held if h[0] == 0]
    log(f"float64 plain lam sweep, {SNS_WITNESS_ITERS} iterations ({wit_s:.1f} "
        f"s): truth-R2 of mu*alpha "
        f"{r2_wit:.4f} (kernel fit {r2_w:.4f}), of mu "
        f"{r2_score(w, witness.state['mu']):.4f}")
    log(f"the kernel on the witness's {len(held)} sweep inputs: gate "
        f"decisions differing per sweep {flips}; largest |kernel - float64 "
        f"plain| in the {len(clean)} sweeps with none differing "
        f"{max(clean, default=0.0):.3e}; rows gated off in the last sweep "
        f"{held[-1][2]}")
    if len(held) != SNS_WITNESS_ITERS or max(flips) > 0.005 * N:
        raise AssertionError(f"SnS: the kernel's gate decisions differ from "
                             f"the float64 plain sweep's beyond 0.5%: {flips}")
    if max(clean, default=0.0) > 1e-4:
        raise AssertionError(f"SnS: the kernel differs from the float64 "
                             f"plain sweep by {max(clean):.3e} (> 1e-4)")
    return launches, dict(warm_s=warm_s, r2_mu_alpha=r2_w,
                          r2_mu=r2_mu, witness_r2_mu_alpha=r2_wit,
                          witness_flips=flips,
                          witness_max_err=max(clean, default=0.0))


def phase_mbcs(sim, dem):
    """MBCS through ``Model.fit``, 20 iterations on the demixed traces
    (50 until the streaming phases came: cut for the call's time), with
    the Monte Carlo noise model and then its exact moments: plain
    PyTorch on the card (no kernel of the port runs), truth-R2 at least
    0.9, no NaN."""
    from circuitmap_torch import Model
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 14: MBCS, 20 iterations, on the demixed traces")
    paths, out = {}, {}
    for analytic in (False, True):
        name = "mbcs_analytic" if analytic else "mbcs"
        reset_counts()
        model, fit_s = timed(lambda: Model(N).fit(
            dem, sim["stim_matrix"], method="mbcs",
            fit_options={"iters": 20, "analytic_noise": analytic}))
        paths[name] = kernel_launches(read_counts())
        r2 = r2_score(sim["weights"], model.state["mu"])
        log(f"analytic_noise={analytic}: {fit_s:.3f} s (histories pulled); "
            f"truth-R2 {r2:.4f} (the JAX package's docstring, TPU era: "
            f"0.976); {int((model.state['mu'] != 0).sum())} connected; "
            f"launches {paths[name]}")
        for key in ("mu", "beta", "lam", "shape", "rate", "z",
                    "receptive_fields"):
            if np.isnan(np.asarray(model.state[key])).any():
                raise AssertionError(f"MBCS posterior {key} holds a NaN")
        if r2 < 0.9:
            raise AssertionError(f"MBCS (analytic_noise={analytic}): "
                                 f"truth-R2 {r2:.4f} < 0.9")
        out[name] = dict(s=fit_s, r2=r2)
    return paths, out


def phase_ard(sim, dem):
    """``mbcs_ard`` for 30 iterations on the demixed traces: B3 once an
    iteration, no NaN; the truth-R2 of mu*(|mu| > 0.5) is recorded."""
    import torch
    from circuitmap_torch import mbcs_ard
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 15: MBCS-ARD, 30 iterations, on the demixed traces")
    reset_counts()
    out, fit_s = timed(lambda: mbcs_ard(dem, sim["stim_matrix"], iters=30,
                                        verbose=False))
    launches = kernel_launches(read_counts())
    for name, v in zip(("mu", "beta", "relevance", "lam", "sigma2", "z"),
                       out):
        if not torch.isfinite(v).all():
            raise AssertionError(f"ARD output {name} is not finite")
    mu = out[0].cpu().numpy()
    r2 = r2_score(sim["weights"], mu * (np.abs(mu) > 0.5))
    log(f"fit {fit_s:.3f} s; launches {launches}; truth-R2 of "
        f"mu*(|mu|>0.5) {r2:.4f}; {int((np.abs(mu) > 0.5).sum())} kept")
    if launches != launch_dict(0, 0, 30):
        raise AssertionError(f"a 30-iteration ARD fit must launch the row "
                             f"kernel 30 times and nothing else: {launches}")
    return launches, dict(s=fit_s, r2=r2)


def phase_elbo(sim, dem):
    """The main-path fit with ``track_elbo=True`` equals the untracked
    fit on the same seed (the bound changes no state) to 1e-6 relative,
    with every bound finite; a second tracked fit, warm, against the
    untracked one gives the bound's cost an iteration; with
    ``elbo_tol=1e-4`` B1 launches once a live iteration (up to and
    including the stopping one)."""
    from circuitmap_torch import Model

    log("phase 16: the main-path fit with track_elbo, and with "
        "elbo_tol=1e-4")
    opts = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
            "verbose": False}

    def fit(**extra):
        return Model(N).fit(dem, sim["stim_matrix"], method="caviar",
                            fit_options={**opts, **extra})

    plain, plain_s = timed(fit)
    reset_counts()
    tracked, fit_s = timed(lambda: fit(track_elbo=True))
    paths = {"elbo": kernel_launches(read_counts())}
    _, warm_s = timed(lambda: fit(track_elbo=True))
    bound_ms = (warm_s - plain_s) / 50 * 1e3
    worst = 0.0
    for key in ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"):
        a, b = np.asarray(tracked.state[key]), np.asarray(plain.state[key])
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"track_elbo changed the NaNs of {key}")
        scale = max(float(np.nanmax(np.abs(b))), 1e-30) if b.size else 1.0
        rel = float(np.nanmax(np.abs(a - b))) / scale if b.size else 0.0
        worst = max(worst, rel)
    elbos = tracked.elbo
    log(f"untracked fit {plain_s:.3f} s, tracked fit first {fit_s:.3f} s "
        f"and warm {warm_s:.3f} s: the bound costs {bound_ms:.2f} ms an "
        "iteration")
    log(f"tracked fit launches {paths['elbo']}; largest "
        f"relative difference from the untracked fit {worst:.3e}; bound "
        f"{elbos[0]:.6g} -> {elbos[-1]:.6g}")
    if worst > 1e-6:
        raise AssertionError(f"track_elbo changed the fit by {worst:.3e} "
                             "relative (> 1e-6)")
    if elbos.shape != (50,) or not np.isfinite(elbos).all():
        raise AssertionError("the tracked bounds are not 50 finite values")
    reset_counts()
    stopped, stop_s = timed(lambda: fit(track_elbo=True, elbo_tol=1e-4))
    paths["elbo_tol"] = kernel_launches(read_counts())
    stop_at = stopped.elbo_converged_at
    live = min(stop_at + 1, 50)
    log(f"elbo_tol=1e-4: stop_at {stop_at}, {stop_s:.3f} s; launches "
        f"{paths['elbo_tol']}")
    if paths["elbo_tol"]["sweep_blocked"] != live:
        raise AssertionError(f"B1 must launch once a live iteration "
                             f"({live}): {paths['elbo_tol']}")
    return paths, dict(untracked_s=plain_s, tracked_s=fit_s,
                       tracked_warm_s=warm_s, bound_ms_per_iteration=bound_ms,
                       max_rel_diff=worst, stop_at=stop_at, stopped_s=stop_s)


def max_rel_diff(a, b, fields):
    """The largest difference between two fits over ``fields``, each
    relative to the field's largest magnitude in ``b`` (NaNs must sit in
    the same places)."""
    import torch

    worst = 0.0
    for f in fields:
        x, y = (np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64)
                for v in (a[f], b[f]))
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            return float("inf")
        scale = max(float(np.nanmax(np.abs(y))), 1e-30) if y.size else 1.0
        worst = max(worst, float(np.nanmax(np.abs(x - y))) / scale
                    if y.size else 0.0)
    return worst


FIT_FIELDS = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")


def phase_block16_fit(sim, dem):
    """Phase 17: the main-path fit at a pinned sweep_block_size=16 (a
    size the port refused on CUDA before): B1 at 16 rows a step once an
    iteration, truth-R2 at least 0.98."""
    from circuitmap_torch import Model
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 17: the main-path fit at sweep_block_size=16, 50 iterations")
    reset_counts()
    model, fit_s = timed(lambda: Model(N).fit(
        dem, sim["stim_matrix"], method="caviar",
        fit_options={"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
                     "verbose": False, "sweep_block_size": 16}))
    launches = kernel_launches(read_counts())
    r2 = r2_score(sim["weights"], model.state["mu"])
    log(f"fit {fit_s:.3f} s; launches {launches}; truth-R2 {r2:.4f}")
    if launches["sweep_blocked"] != 50 or launches["sweep_row"] != 0:
        raise AssertionError(f"block 16 must launch B1 50 times: {launches}")
    if np.isnan(model.state["mu"]).any() or r2 < 0.98:
        raise AssertionError(f"block-16 fit: truth-R2 {r2:.4f} < 0.98 or NaN")
    return launches, dict(s=fit_s, r2=r2)


def caviar_args(dem, sim):
    from circuitmap_torch import default_priors

    p = default_priors(N)
    return (dem, sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
            p["rate"], p["phi"], p["phi_cov"])


def fit_dict(out):
    return dict(zip(FIT_FIELDS, out[:8]))


def phase_resumable(sim, dem):
    """Phase 18: caviar_resumable on the main path's map, 50 iterations
    in segments of 10, against the one-shot caviar() at the same seed
    (1e-6 relative); then a call stopped after 20 iterations and a
    second call that resumes from its file, against the same."""
    import tempfile

    from circuitmap_torch import caviar, caviar_resumable

    log("phase 18: caviar_resumable, 50 iterations in segments of 10, "
        "against the one-shot fit")
    args = caviar_args(dem, sim)
    kw = dict(iters=50, msrmp=0.3, powers=list(POWERS), verbose=False,
              seed=0)
    one, one_s = timed(lambda: caviar(*args, **kw))
    one = fit_dict(one)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        seg, seg_s = timed(lambda: caviar_resumable(
            *args, f"{tmp}/fit", checkpoint_every=10, **kw))
        launches = kernel_launches(read_counts())
        d_seg = max_rel_diff(fit_dict(seg), one, FIT_FIELDS)
        size_mb = Path(f"{tmp}/fit.npz").stat().st_size / 1e6
        caviar_resumable(*args, f"{tmp}/stop", checkpoint_every=10,
                         **{**kw, "iters": 20})
        resumed, res_s = timed(lambda: caviar_resumable(
            *args, f"{tmp}/stop", checkpoint_every=10, **kw))
        d_res = max_rel_diff(fit_dict(resumed), one, FIT_FIELDS)
    per_segment_ms = (seg_s - one_s) / 5 * 1e3
    log(f"one-shot {one_s:.3f} s, segmented {seg_s:.3f} s ({per_segment_ms:.1f}"
        f" ms a segment more; a checkpoint is {size_mb:.1f} MB), resumed "
        f"from iteration 20 {res_s:.3f} s; launches {launches}; largest "
        f"relative difference from the one-shot fit: segmented {d_seg:.3e}, "
        f"resumed {d_res:.3e}")
    if max(d_seg, d_res) > 1e-6:
        raise AssertionError("the resumable fit differs from the one-shot "
                             f"fit: {d_seg:.3e}, {d_res:.3e} (> 1e-6)")
    if launches["sweep_blocked"] != 50:
        raise AssertionError(f"the segmented fit must launch B1 50 times: "
                             f"{launches}")
    return launches, dict(one_shot_s=one_s, segmented_s=seg_s,
                          resumed_s=res_s, per_segment_ms=per_segment_ms,
                          checkpoint_mb=size_mb, max_rel_diff=max(d_seg,
                                                                  d_res))


STREAM_BLOCKS, STREAM_TRIALS = 10, 2000


def phase_online(sim, dem):
    """Phase 19: OnlineCaviar on the main path's map. One update of all
    20,000 trials at 50 iterations against the batch caviar() fit (both
    at max_backtrack_iters=50: with the default 20 the stream caps the
    spontaneous update's seed from iteration 20 on, by design), 1e-6
    relative. Then a stream of 10 blocks of 2,000 trials at 10
    iterations with the reconnection scan, from the default capacity
    1024 (the buffers grow): each block's update latency
    (host-synchronised), the launches, the final truth-R2 (at least
    0.95); and a stream saved after block 5 and loaded, equal to the
    uninterrupted one (1e-6 relative)."""
    import tempfile

    import torch
    from circuitmap_torch import OnlineCaviar, caviar
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 19: OnlineCaviar on the main path's map")
    paths = {}
    args = caviar_args(dem, sim)
    kw = dict(msrmp=0.3, max_backtrack_iters=50)
    batch = fit_dict(caviar(*args, iters=50, fn_scan=False, verbose=False,
                            powers=list(POWERS), **kw))
    # buffers of the block's width: the batch fit's shapes, so its sums
    oc = OnlineCaviar(N, powers=list(POWERS), capacity=K, **kw)
    reset_counts()
    _, one_s = timed(lambda: oc.update(dem, sim["stim_matrix"], iters=50,
                                       fn_scan=False))
    paths["online_one_block"] = kernel_launches(read_counts())
    d_one = max_rel_diff(oc.result(fn_scan=False), batch, FIT_FIELDS)
    log(f"one update of {K} trials at 50 iterations {one_s:.3f} s; launches "
        f"{paths['online_one_block']}; largest relative difference from "
        f"the batch fit {d_one:.3e}")
    if d_one > 1e-6:
        raise AssertionError(f"one update differs from the batch fit by "
                             f"{d_one:.3e} (> 1e-6)")
    del oc, batch

    host = dem.cpu().numpy()
    stim = sim["stim_matrix"]
    edges = [b * STREAM_TRIALS for b in range(STREAM_BLOCKS + 1)]

    def feed(stream, lo, hi, times=None):
        for a, b in zip(edges[lo:hi], edges[lo + 1:hi + 1]):
            t0 = time.perf_counter()
            stream.update(host[a:b], stim[:, a:b], iters=10)
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)

    stream = OnlineCaviar(N, powers=list(POWERS))
    times, caps = [], []
    reset_counts()
    for blk in range(STREAM_BLOCKS):
        feed(stream, blk, blk + 1, times)
        caps.append(stream._C)
    paths["online_stream"] = kernel_launches(read_counts())
    res = stream.result()
    r2 = r2_score(sim["weights"], res["mu"])
    steady = statistics.median(times[3:])
    log(f"stream of {STREAM_BLOCKS} blocks of {STREAM_TRIALS} trials, 10 "
        f"iterations each: update ms per block "
        + ", ".join(f"{t:.1f}" for t in times)
        + f"; steady median (blocks 4-10) {steady:.1f} ms; capacity per "
        f"block {caps}; launches {paths['online_stream']}; truth-R2 "
        f"{r2:.4f}")
    if r2 < 0.95 or np.isnan(res["mu"]).any():
        raise AssertionError(f"stream truth-R2 {r2:.4f} < 0.95 or NaN")
    if paths["online_stream"]["sweep_blocked"] != 10 * STREAM_BLOCKS:
        raise AssertionError("the stream must launch B1 10 times a block: "
                             f"{paths['online_stream']}")

    part = OnlineCaviar(N, powers=list(POWERS))
    with tempfile.TemporaryDirectory() as tmp:
        feed(part, 0, 5)
        part.save(f"{tmp}/stream.npz")
        reset_counts()
        part = OnlineCaviar.load(f"{tmp}/stream.npz")
        feed(part, 5, STREAM_BLOCKS)
        paths["online_resumed"] = kernel_launches(read_counts())
    d_load = max_rel_diff(part.result(), res, FIT_FIELDS)
    log(f"saved after block 5, loaded, 5 more blocks: largest relative "
        f"difference from the uninterrupted stream {d_load:.3e}")
    if d_load > 1e-6:
        raise AssertionError(f"the reloaded stream differs by {d_load:.3e}")
    return paths, dict(one_block_s=one_s, one_block_rel_diff=d_one,
                       block_ms=times, steady_median_ms=steady,
                       capacity=caps, r2=r2, reload_rel_diff=d_load)


def phase_closed_loop():
    """Phase 20: closed_loop_map at N=1000, H=10, 2000 trials a round,
    at most 5 rounds of 8 iterations, each block demixed (int4d2
    checkpoint, float32 wire); ``acquire`` simulates the trials on one
    fixed truth drawn from a pilot simulation. Truth-R2 at least 0.8
    (the JAX package's test bar)."""
    from circuitmap_torch import NeuralDemixer, closed_loop_map, simulate
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 20: closed_loop_map, N=1000, H=10, 2000 trials a round, "
        "at most 5 rounds")
    np.random.seed(4)
    pilot = simulate(N=N, trials=STREAM_TRIALS, H=H, connection_prob=0.05,
                     powers=list(POWERS), verbose=False)
    truth = {k: pilot[k] for k in ("weights", "phi_0", "phi_1", "tau_r",
                                   "tau_d")}

    def acquire(stim):
        return simulate(N=N, stim_matrix=stim, weights=truth["weights"],
                        phi_0=truth["phi_0"], phi_1=truth["phi_1"],
                        kernel=(truth["tau_r"], truth["tau_d"]),
                        powers=list(POWERS), batch_size=1000,
                        verbose=False)["psc"]

    rounds = []
    reset_counts()
    (post, designer, solver), loop_s = timed(lambda: closed_loop_map(
        acquire, N=N, H=H, powers=list(POWERS), block_trials=STREAM_TRIALS,
        max_rounds=5, iters_per_round=8,
        demixer=NeuralDemixer(str(CHECKPOINT)),
        callback=lambda r, d, p: rounds.append(int(d.pool.size))))
    launches = kernel_launches(read_counts())
    r2 = r2_score(truth["weights"], post["mu"])
    log(f"{designer.rounds} rounds in {loop_s:.2f} s; pool after each round "
        f"{rounds}; {solver.trial_count} trials; launches {launches}; "
        f"truth-R2 {r2:.4f}")
    if r2 < 0.8 or launches["sweep_blocked"] != 8 * designer.rounds:
        raise AssertionError(f"closed loop: truth-R2 {r2:.4f} < 0.8, or B1 "
                             f"not 8 launches a round: {launches}")
    return launches, dict(rounds=designer.rounds, pool=rounds, s=loop_s,
                          r2=r2)


def fold_stack(sim, dem):
    """Phase 10's 4 folds: [4, 15000, 900] device traces, stims."""
    import torch

    q = K // 4
    keeps = [np.r_[0:f * q, (f + 1) * q:K] for f in range(4)]
    ys = torch.stack([dem[torch.from_numpy(kp).cuda()] for kp in keeps])
    return ys, np.stack([sim["stim_matrix"][:, kp] for kp in keeps])


def ragged_folds(sim, dem):
    """Phase 11's ragged folds, as host lists."""
    host = dem.cpu().numpy()
    idx = [(np.arange(k) + K // 10 * f) % K for f, k in enumerate(RAGGED)]
    return [host[i] for i in idx], [sim["stim_matrix"][:, i] for i in idx]


def compare_folds(a, b, fields, what, tol=1e-4):
    diffs = [max_rel_diff(x, y, fields) for x, y in zip(a, b)]
    log(f"{what}: largest relative difference per fold "
        + ", ".join(f"{d:.3e}" for d in diffs))
    if max(diffs) > tol:
        raise AssertionError(f"{what}: {max(diffs):.3e} > {tol}")
    return diffs


def phase_many_baselines(sim, dem):
    """Phase 21: sns_many (SNS_MANY_ITERS iterations) and mbcs_many (10
    iterations) on phase 10's 4 folds, sequential and batched. Batched
    equals sequential fold by fold to 1e-4 relative at a fixed row order
    with exact means (SnS) and at the same random orders with exact noise
    moments (MBCS); SnS's random order is printed, not compared (its
    gate is absorbing). Batched SnS launches the batched row kernel and
    the Laplace kernel once an iteration each. MBCS folds at truth-R2 0.9
    or more. A ragged sns_many (5 iterations) equals the single cavi_sns
    fits."""
    from circuitmap_torch import cavi_sns, default_priors, mbcs_many, sns_many
    from circuitmap_torch.utils.metrics import r2_score

    log(f"phase 21: sns_many ({SNS_MANY_ITERS} iterations) and mbcs_many "
        "(10 iterations) on the 4 folds")
    ys, stims = fold_stack(sim, dem)
    p = default_priors(N)
    sns_priors = (p["mu"], p["beta"], p["alpha"], p["shape"], p["rate"],
                  p["phi"], p["phi_cov"])
    sns_fields = ("mu", "beta", "alpha", "lam", "shape", "rate", "phi",
                  "phi_cov")
    w = sim["weights"]
    paths, out = {}, {}
    fixed = dict(iters=SNS_MANY_ITERS, update_order="identity",
                 analytic_mc=True, verbose=False)
    runs = {}
    for mode in ("sequential", "batched"):
        reset_counts()
        runs[mode], out[f"sns_{mode}_s"] = timed(lambda: sns_many(
            ys, stims, *sns_priors, compile_mode=mode, **fixed))
        paths[f"sns_many_{mode}"] = kernel_launches(read_counts())
        log(f"sns_many {mode} (identity order, exact means) "
            f"{out[f'sns_{mode}_s']:.3f} s; launches {read_counts()}")
    if paths["sns_many_batched"] != launch_dict(0, SNS_MANY_ITERS,
                                                SNS_MANY_ITERS):
        raise AssertionError(f"batched sns_many must launch B5 and B2 "
                             f"{SNS_MANY_ITERS} times each: "
                             f"{paths['sns_many_batched']}")
    out["sns_rel_diff"] = compare_folds(runs["batched"], runs["sequential"],
                                        sns_fields, "sns_many batched vs "
                                        "sequential")
    rnd, out["sns_random_batched_s"] = timed(lambda: sns_many(
        ys, stims, *sns_priors, iters=SNS_MANY_ITERS, compile_mode="batched",
        verbose=False))
    out["sns_random_r2_mu_alpha"] = [r2_score(w, r["mu"] * r["alpha"])
                                     for r in rnd]
    log(f"sns_many batched, random order: {out['sns_random_batched_s']:.3f} "
        "s; truth-R2 of mu*alpha per fold "
        + ", ".join(f"{v:.4f}" for v in out["sns_random_r2_mu_alpha"]))

    mruns = {}
    for mode in ("sequential", "batched"):
        reset_counts()
        mruns[mode], out[f"mbcs_{mode}_s"] = timed(lambda: mbcs_many(
            ys, stims, p["mu"], p["beta"], p["shape"], p["rate"], iters=10,
            analytic_noise=True, compile_mode=mode, verbose=False))
        paths[f"mbcs_many_{mode}"] = kernel_launches(read_counts())
        log(f"mbcs_many {mode} (exact noise moments) "
            f"{out[f'mbcs_{mode}_s']:.3f} s")
    out["mbcs_rel_diff"] = compare_folds(
        mruns["batched"], mruns["sequential"],
        ("mu", "beta", "lam", "shape", "rate", "z", "receptive_fields"),
        "mbcs_many batched vs sequential")
    out["mbcs_r2"] = [r2_score(w, r["mu"]) for r in mruns["batched"]]
    log("mbcs_many truth-R2 per fold "
        + ", ".join(f"{v:.4f}" for v in out["mbcs_r2"]))
    if min(out["mbcs_r2"]) < 0.9:
        raise AssertionError(f"mbcs_many: a fold below truth-R2 0.9: "
                             f"{out['mbcs_r2']}")
    del ys

    rys, rstims = ragged_folds(sim, dem)
    reset_counts()
    rag, out["sns_ragged_s"] = timed(lambda: sns_many(
        rys, rstims, *sns_priors, iters=5, verbose=False))
    paths["sns_many_ragged"] = kernel_launches(read_counts())
    singles = [dict(zip(sns_fields, cavi_sns(
        y, s, *sns_priors, iters=5, seed=b, save_histories=False,
        verbose=False)[:8])) for b, (y, s) in enumerate(zip(rys, rstims))]
    out["sns_ragged_rel_diff"] = compare_folds(
        rag, singles, sns_fields, "ragged sns_many vs single cavi_sns fits",
        tol=1e-6)
    log(f"ragged sns_many {out['sns_ragged_s']:.3f} s; launches "
        f"{paths['sns_many_ragged']}")
    return paths, out


LEVEL_COUNTS = (24, 64, 1024)   # phase 3c: past the 16 compile-time levels
LONG_BLOCKS = (48, 64, 125)     # phase 3c: past one warp's 32 rows


def phase_repaired_kernels():
    """Phase 3c: the sweep at 24, 64 and 1024 power levels (8 rows a
    step; above 16 levels the per-level sums go through global scratch)
    and at 48, 64 and 125 rows a block (P=3; sub-steps of at most 32
    rows against the block's residual), and the Laplace kernel at 25, 65
    and 1025 buckets (its bucket loop at run time), each against its
    plain version as phase 3b holds them (N=1000, K=20000)."""
    from circuitmap_torch.ops import sweep_cuda as sc
    from circuitmap_torch.solvers._laplace import powercurve_stats

    log(f"phase 3c: cluster sweep at {LEVEL_COUNTS} power levels (8 rows a "
        f"step) and at {LONG_BLOCKS} rows a block (P=3); Laplace at "
        f"{tuple(p + 1 for p in LEVEL_COUNTS)} buckets (N=1000, K=20000)")
    levels, blocks, laplace = {}, {}, {}
    for P in LEVEL_COUNTS:
        powers = tuple(float(v) for v in np.linspace(30.0, 75.0, P))
        a = sweep_inputs(seed=100 + P, powers=powers)
        levels[P] = check_blocked(a, 8, f"8 rows a step, P={P}")
        lam = sweep_call(sc.sweep_spikes_blocked_torch, a, 1)
        S, C, lv = powercurve_stats(lam, a["stim"], a["powers"],
                                    total_trials=K,
                                    counts=a["power_counts"])
        laplace[P + 1] = check_laplace(S, C, lv, f"N=1000, P+1={P + 1}")
        del a, lam, S, C
    for block in LONG_BLOCKS:
        blocks[block] = check_blocked(sweep_inputs(seed=block, block=block),
                                      block, f"{block} rows a block, P=3")
    return dict(levels=levels, blocks=blocks, laplace=laplace)


def relevelled(stim, n_offsets=8, seed=0):
    """The stim with each nonzero entry moved by one of ``n_offsets``
    offsets of 0.25 (centred on 0): 3 levels become 24, close enough to
    the simulated powers for the same map."""
    rng = np.random.default_rng(seed)
    offsets = 0.25 * (np.arange(n_offsets) - (n_offsets - 1) / 2)
    out = np.array(stim, dtype=np.float64)
    nz = out != 0
    out[nz] += offsets[rng.integers(0, n_offsets, int(nz.sum()))]
    return out


def phase_repaired_fits(sim, dem):
    """Phase 3c, the fits: the main-path fit at sweep_block_size=64 and
    on a re-levelled stim of 24 power levels (50 iterations each), which
    the port refused on CUDA before. Each launches B1 once an iteration;
    no posterior may hold a NaN; their truth-R2 is printed."""
    from circuitmap_torch import Model
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 3c: main-path fits at sweep_block_size=64 and on a 24-level "
        "stim, 50 iterations each")
    paths, out = {}, {}
    stim24 = relevelled(sim["stim_matrix"])
    for name, stim, extra in (
            ("block64_fit", sim["stim_matrix"],
             {"powers": list(POWERS), "sweep_block_size": 64}),
            ("levels24_fit", stim24, {})):
        reset_counts()
        model, fit_s = timed(lambda: Model(N).fit(
            dem, stim, method="caviar",
            fit_options={"iters": 50, "msrmp": 0.3, "verbose": False,
                         **extra}))
        launches = kernel_launches(read_counts())
        r2 = r2_score(sim["weights"], model.state["mu"])
        n_levels = np.unique(stim[stim != 0]).size
        log(f"{name}: {n_levels} levels, fit {fit_s:.3f} s; launches "
            f"{launches}; truth-R2 {r2:.4f}")
        if launches["sweep_blocked"] != 50 or launches["laplace"] < 50:
            raise AssertionError(f"{name}: B1 must launch 50 times and B2 "
                                 f"at least 50: {launches}")
        for key in FIT_FIELDS:
            if np.isnan(np.asarray(model.state[key])).any():
                raise AssertionError(f"{name}: posterior {key} holds a NaN")
        paths[name] = launches
        out[name] = dict(s=fit_s, r2=r2, levels=n_levels)
    return paths, out


TRAIN_BASE = HERE / "demixers" / "nwd_ie_ChroME2f.npz"
# the chrome2f_ie preset's data of the int4d2 QAT fine-tune
# (scripts_tpu/train_qat_demixer.py:80-95, scripts_tpu/train_demixer.py:22)
QAT_DATA = dict(trial_dur=900, size=50000, gp_scale=0.045, delta_lower=160,
                delta_upper=400, next_delta_lower=400, next_delta_upper=899,
                prev_delta_upper=150, tau_r_lower=10, tau_r_upper=40,
                tau_diff_lower=150, tau_diff_upper=340,
                noise_std_lower=0.001, noise_std_upper=0.02,
                gp_lengthscale=45, seed=0)


def state_rel_diff(a, b):
    """max |a - b| over every floating entry of two state_dicts, over
    max |b| of the same entries (a BatchNorm bias near 0 makes a
    tensor-by-tensor ratio noise: tests/test_torch_training.py)."""
    keys = [k for k, v in b.items() if v.is_floating_point()]
    err = max((a[k].double().cpu() - b[k].double().cpu()).abs().max().item()
              for k in keys)
    return err / max(b[k].double().abs().max().item() for k in keys)


PROFILED_STEPS = 100  # phase 22's profiled epoch: 6,400 of the pairs


def sgd_steps(dm, x, y, batches, lr):
    """``len(batches)`` SGD steps of ``NeuralDemixer.train`` on dm's
    network (train mode, TF32 off), batch i taking rows batches[i]."""
    import torch

    opt = torch.optim.SGD(dm.net.parameters(), lr=lr)
    dm.net.train()
    with dm._precision():
        for idx in batches:
            opt.zero_grad(set_to_none=True)
            dm._loss(x[idx], y[idx]).backward()
            opt.step()
    dm.net.eval()


def phase_training(sim, dem):
    """Phase 22: the int4d2 QAT fine-tune at full width and on the full
    dataset, 3 epochs: from demixers/nwd_ie_ChroME2f.npz on 50,000
    generated pairs (the chrome2f_ie preset, seed 0), inputs through the
    int4d2 wire, lr 2e-3, batch 64. Holds: its first 3 SGD steps on the
    card equal the same steps on the CPU in float32 to 1e-4 of the
    state's largest entry; the validation loss after epoch 3 at most the
    starting checkpoint's on the same test set; the weights saved and
    reloaded (.npz and Lightning .ckpt) equal bit for bit. Prints s an
    epoch, steps/s and the idle share of one profiled epoch, then
    demixes and fits the main map with the trained network beside the
    shipped int4d2 QAT checkpoint. Returns the trained demixer."""
    import tempfile

    import torch
    from circuitmap_torch import Model, NeuralDemixer
    from circuitmap_torch.demix import convert
    from circuitmap_torch.demix.demixer import wire_transform
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 22: demixer training, the int4d2 QAT fine-tune (50,000 "
        "pairs, 3 epochs, lr 2e-3, batch 64)")
    dm = NeuralDemixer(str(TRAIN_BASE))
    np.random.seed(0)  # the GP noise draws from the global stream
    t0 = time.time()
    (x_tr, y_tr), (x_te, y_te) = dm.generate_training_data(**QAT_DATA)
    gen_s = time.time() - t0
    t0 = time.time()
    x_tr, x_te = wire_transform(x_tr, 4, 2), wire_transform(x_te, 4, 2)
    dm.training_data, dm.test_data = (x_tr, y_tr), (x_te, y_te)
    log(f"data: {x_tr.shape[0]} train / {x_te.shape[0]} test pairs, "
        f"generated in {gen_s:.2f} s, int4d2 wire in {time.time() - t0:.2f} s")

    # the first 3 steps on the card and on the CPU, from the same weights
    # on the same batches (train's own: its first permutation)
    lr, batch = 2e-3, 64
    rows = np.random.default_rng(0).permutation(x_tr.shape[0])[:3 * batch]
    steps, step_s = {}, {}
    for dev in ("cuda", "cpu"):
        d = NeuralDemixer(str(TRAIN_BASE), device=dev)
        x = torch.from_numpy(np.asarray(x_tr[rows], np.float32)).to(dev)
        y = torch.from_numpy(np.asarray(y_tr[rows], np.float32)).to(dev)
        _, step_s[dev] = timed(lambda: sgd_steps(
            d, x, y, [slice(i * batch, (i + 1) * batch) for i in range(3)],
            lr))
        steps[dev] = d
    rel = state_rel_diff(steps["cuda"].net.state_dict(),
                         steps["cpu"].net.state_dict())
    log(f"3 SGD steps, card vs CPU (float32, TF32 off): max |diff| / max "
        f"|entry| over the state {rel:.3e} (card {step_s['cuda']:.2f} s, "
        f"CPU {step_s['cpu']:.2f} s)")
    if rel > 1e-4:
        raise AssertionError(f"3 train steps on the card differ from the CPU "
                             f"by {rel:.3e} > 1e-4 of the state")

    up = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    te = (up(x_te), up(y_te))
    val0 = dm._val_loss(*te)
    torch.cuda.synchronize()
    t0 = time.time()
    history = dm.train(epochs=3, learning_rate=lr, batch_size=batch, seed=0,
                       verbose=False)
    torch.cuda.synchronize()
    train_s = time.time() - t0
    n_steps = x_tr.shape[0] // batch
    log(f"3 epochs in {train_s:.2f} s: {train_s / 3:.3f} s an epoch, "
        f"{3 * n_steps / train_s:.1f} steps/s ({n_steps} steps an epoch); "
        f"history {history}")
    log(f"val loss: starting checkpoint {val0:.6f}, after epoch 3 "
        f"{history[-1]['val_loss']:.6f} (the QAT checkpoint's record, 150 "
        "epochs: 0.000600)")
    if not history[-1]["val_loss"] <= val0:
        raise AssertionError(f"val loss after 3 epochs "
                             f"{history[-1]['val_loss']:.6f} > the starting "
                             f"checkpoint's {val0:.6f}")

    sd = dm.net.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        dm.save(f"{tmp}/trained.npz")
        convert.save_lightning_checkpoint(f"{tmp}/trained.ckpt", sd,
                                          epoch=3, global_step=3 * n_steps)
        for name in ("trained.npz", "trained.ckpt"):
            back = NeuralDemixer(f"{tmp}/{name}").net.state_dict()
            for k, v in sd.items():
                if v.is_floating_point() and not torch.equal(back[k], v):
                    raise AssertionError(f"{name}: {k} changed on reload")
    log("saved and reloaded (.npz, .ckpt): equal bit for bit")

    # one more epoch, profiled, on the 3-step copy (the trained network
    # stays as the 3 epochs left it), over the first PROFILED_STEPS
    # batches' pairs: a full epoch is ~110,000 device operations, whose
    # processing took the profiler ~2 minutes
    prof = steps["cuda"]
    n_prof = PROFILED_STEPS * batch
    prof.training_data = (x_tr[:n_prof], y_tr[:n_prof])
    prof.test_data = (x_te[:0], y_te[:0])
    t0 = time.time()
    rows = profiled(lambda: prof.train(epochs=1, learning_rate=lr,
                                       batch_size=batch, seed=1,
                                       verbose=False),
                    f"train_epoch_of_{PROFILED_STEPS}_steps")
    log(f"profiled epoch with the profiler's processing: "
        f"{time.time() - t0:.2f} s")
    del prof, steps

    r2s = {}
    for name, source in (("shipped int4d2 QAT", dem), ("trained", None)):
        traces = source if source is not None else dm(
            sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
            verbose=False)
        model = Model(N).fit(traces, sim["stim_matrix"], method="caviar",
                             fit_options={"iters": 50, "msrmp": 0.3,
                                          "powers": list(POWERS),
                                          "verbose": False})
        r2s[name] = r2_score(sim["weights"], model.state["mu"])
        if np.isnan(model.state["mu"]).any():
            raise AssertionError(f"main map demixed by the {name} network: "
                                 "a NaN weight")
    log(f"main map, int4d2 demix + 50-iteration fit, truth-R2: {r2s}")
    return dm, dict(data_s=gen_s, train_s=train_s, epoch_s=train_s / 3,
                    steps_per_s=3 * n_steps / train_s, val0=val0,
                    history=history, card_vs_cpu_3_steps=rel,
                    profiled=rows is not None, r2=r2s)


def phase_template_fit(dem):
    """Phase 23: ``fit_psc_templates`` on 1,000 of the main map's demixed
    traces (10 kernels, 800 Adam steps, 3 restarts) on the card. Hold:
    50 Adam steps on 32 of them, from their peak-seeded init, in float64
    on the card and on the CPU, agree to 1e-4 (the raw parameters
    relative to their largest entry, the fitted templates relative to
    the traces' peak). The same steps in float32 are printed, not held:
    on these traces float32 Adam drifts from float64 on the CPU alone by
    ~5e-4 of the peak in 50 steps (2e-6 after one step; its first step
    is lr times each gradient component's sign, and the flat components'
    signs follow the rounding). Prints the median fit R2, the seconds and
    ``suggest_datagen_ranges``."""
    import torch
    from circuitmap_torch.demix import template_fit as tf

    log("phase 23: PSC-template fit of 1,000 demixed traces (10 kernels, "
        "800 steps, 3 restarts)")
    traces = dem[:1000].float()
    t_np = np.linspace(-5.0, 40.0, traces.shape[1]).astype(np.float32)
    sub = traces[:32].cpu()
    raw0 = torch.from_numpy(tf._peak_init(sub.numpy(), t_np, 10,
                                          np.random.default_rng(0)))
    diffs = {}
    for dtype in (torch.float64, torch.float32):
        t_cpu, x = torch.from_numpy(t_np).to(dtype), sub.to(dtype)
        raws = {dev: tf._fit_batch(x.to(dev), t_cpu.to(dev),
                                   raw0.to(dev, dtype), 50, 0.05)[0].cpu()
                for dev in ("cuda", "cpu")}
        recon = {dev: tf.sum_of_psc_templates(t_cpu, *tf._unpack(r))
                 for dev, r in raws.items()}
        diffs[str(dtype)[6:]] = (
            ((recon["cuda"] - recon["cpu"]).abs().max() / x.abs().max()
             ).item(),
            ((raws["cuda"] - raws["cpu"]).abs().max()
             / raws["cpu"].abs().max()).item())
    log("50 Adam steps on 32 traces, card vs CPU: (fitted templates max "
        "|diff| / max |trace|, raw parameters max |diff| / max |raw|) "
        f"{diffs}")
    if max(diffs["float64"]) > 1e-4:
        raise AssertionError(f"template fit: card and CPU differ by "
                             f"{diffs['float64']} > 1e-4 in float64 after "
                             "50 steps")
    fit, fit_s = timed(lambda: tf.fit_psc_templates(traces, n_kernels=10,
                                                    steps=800, restarts=3))
    ranges = tf.suggest_datagen_ranges(fit)
    med = float(np.median(fit["r2"]))
    # the R2 of a flat trace (no evoked PSC; its variance near 0) is
    # meaningless: the median over the traces that peak at 10% of the
    # largest peak or more beside it
    peaks = traces.amax(1).cpu().numpy()
    evoked = peaks >= 0.1 * peaks.max()
    med_evoked = float(np.median(fit["r2"][evoked]))
    log(f"fit {fit_s:.2f} s; median fit R2 {med:.4f} over all 1,000, "
        f"{med_evoked:.4f} over the {int(evoked.sum())} traces peaking at "
        f">= 10% of the largest; suggest_datagen_ranges {ranges}")
    if not np.isfinite(fit["reconstruction"]).all():
        raise AssertionError("template fit: non-finite reconstruction")
    return dict(s=fit_s, median_r2=med, median_r2_evoked=med_evoked,
                card_vs_cpu_50_steps=diffs, ranges=ranges)


def fidelity(true, demixed):
    """Mean per-trial R2 of the demixed windows against the true evoked
    responses, over trials with a response
    (scripts_tpu/run_signal_fidelity.py:33-38)."""
    from circuitmap_torch.utils.metrics import r2_score

    return float(np.mean([r2_score(t, d) for t, d in zip(true, demixed)
                          if t.std() > 0]))


def phase_continuous(trained):
    """Phase 24: ``simulate_continuous_experiment`` at yaml/sweep_tpu.yaml's
    scale (N=300, H=10, 300 s at 20 kHz, 30 Hz stimulation, connection
    probability 0.1, 3 Hz spontaneous events), its windows demixed on the
    int4d2 wire by the shipped QAT checkpoint and by phase 22's network
    (mean per-trial R2 against the true responses), and a 50-iteration
    CAVIaR fit of the shipped demix. Hold: no NaN. Returns the launches,
    the record and the timeline with its stim times (phase 31)."""
    from circuitmap_torch import Model, NeuralDemixer, \
        simulate_continuous_experiment
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 24: continuous experiment, N=300, H=10, 300 s at 20 kHz, "
        "30 Hz stimulation")
    np.random.seed(0)
    expt, sim_s = timed(lambda: simulate_continuous_experiment(
        N=300, H=10, expt_len=300 * 20000, stim_freq=30,
        connection_prob=0.1, spont_rate=3, verbose=False))
    obs = expt["obs_responses"]
    log(f"simulated in {sim_s:.2f} s: {obs.shape[0]} windows, "
        f"{int((expt['weights'] != 0).sum())} connected")
    if not (np.isfinite(obs).all() and np.isfinite(expt["pscs"]).all()):
        raise AssertionError("continuous experiment: non-finite traces")
    r2s, dems = {}, {}
    for name, dm in (("shipped int4d2 QAT", NeuralDemixer(str(CHECKPOINT))),
                     ("trained", trained)):
        dems[name] = dm(obs, transfer_dtype="int4d2", verbose=False)
        r2s[name] = fidelity(expt["true_responses"], dems[name])
    log(f"mean per-trial R2 (true vs demixed): {r2s}")
    reset_counts()
    model, fit_s = timed(lambda: Model(300).fit(
        dems["shipped int4d2 QAT"], expt["stim_matrix"], method="caviar",
        fit_options={"iters": 50, "powers": [45, 55, 65], "verbose": False}))
    launches = kernel_launches(read_counts())
    r2 = r2_score(expt["weights"], model.state["mu"])
    log(f"CAVIaR fit {fit_s:.3f} s; launches {launches}; truth-R2 {r2:.4f}")
    for key in FIT_FIELDS:
        if np.isnan(np.asarray(model.state[key])).any():
            raise AssertionError(f"continuous fit: posterior {key} is NaN")
    return launches, dict(sim_s=sim_s, fidelity_r2=r2s, fit_s=fit_s,
                          truth_r2=r2, windows=int(obs.shape[0])), \
        (expt["pscs"], expt["stim_times"])


def phase_analysis(sim, dem, model):
    """Phase 25: the analysis tail on phase 5's fit: ``Model.summary``,
    ``split_single_ensemble`` and ``connection_waveforms`` (its ridge
    regression on the card). Prints their seconds and the count of
    connections."""
    from circuitmap_torch import pipelines

    log("phase 25: analysis tail on the main-path fit")
    stim = sim["stim_matrix"]
    summary, sum_s = timed(lambda: model.summary(stim=stim, verbose=False))
    (single, multi), split_s = timed(
        lambda: pipelines.split_single_ensemble(stim))
    (cnx, wf), wf_s = timed(lambda: pipelines.connection_waveforms(
        dem, stim, model.state))
    log(f"summary {sum_s:.3f} s ({summary['connected'].size} connected, "
        f"noise std {summary['noise_std']:.4g}); split {split_s:.3f} s "
        f"({single.size} single-target, {multi.size} ensemble trials); "
        f"connection_waveforms {wf_s:.3f} s ({cnx.size} connections, "
        f"waveforms {wf.shape})")
    if cnx.size != summary["connected"].size or not np.isfinite(wf).all():
        raise AssertionError("analysis tail: waveforms disagree with the "
                             "summary's connections or are not finite")
    return dict(summary_s=sum_s, split_s=split_s, waveforms_s=wf_s,
                connections=int(cnx.size))


SERVED_FIELDS = ("mu", "beta", "alpha")  # phase 26's return_fields


class ServedPhase:
    """Phase 26's in-process server: ``FitService`` (CUDA, the int4d2
    QAT demixer) behind the HTTP handler on 127.0.0.1:<free port>, on a
    thread of its own, with its per-request log in memory (the server's
    ``--metrics`` lines: seconds, bytes in and out)."""

    def __init__(self):
        import io
        import threading
        from http.server import HTTPServer

        from circuitmap_torch import serve as ts

        self.svc = ts.FitService(demixer_path=str(CHECKPOINT))
        self.svc.metrics_fh = io.StringIO()
        box = [None]
        self.httpd = HTTPServer(("127.0.0.1", 0),
                                ts._make_handler(self.svc, box))
        box[0] = self.httpd
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.client = ts.FitClient(
            f"http://127.0.0.1:{self.httpd.server_address[1]}", timeout=600)

    def last_request(self):
        """The server's log line of the latest request."""
        return json.loads(self.svc.metrics_fh.getvalue().splitlines()[-1])

    def timed_request(self, fn):
        """(response, client wall s, the server's log line) of one
        request; the line holds the server's own seconds and the bytes
        in and out."""
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        rec = self.last_request()
        if rec["status"] != 200:
            raise AssertionError(f"request failed: {rec}")
        return out, wall, rec

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def served_variants(served, sim, opts, full):
    """Phase 26 (d): the served fit with return_fields and with the int8
    lam wire, 3 warm requests each: (wall medians, bytes in and out)."""
    stim = sim["stim_matrix"]
    variants = {"full": {}, "return_fields": {"return_fields": SERVED_FIELDS},
                "int8": {"response_wire": "int8"}}
    out = {}
    for name, extra in variants.items():
        runs = [served.timed_request(lambda: served.client.fit(
            sim["psc"], stim, psc_wire="int4d2", demix=True,
            trace_wire="int4d2", **opts, **extra)) for _ in range(3)]
        resp = runs[-1][0]
        walls = [r[1] for r in runs]
        out[name] = dict(wall_s=statistics.median(walls), walls_s=walls,
                         server_s=statistics.median(
                             r[2]["seconds"] for r in runs),
                         bytes_in=runs[-1][2]["bytes_in"],
                         bytes_out=runs[-1][2]["bytes_out"])
        if not np.array_equal(resp["mu"], full["mu"]):
            raise AssertionError(f"served fit ({name}): mu differs from "
                                 "the first served fit")
        if name == "return_fields" and set(resp) != {*SERVED_FIELDS,
                                                     "fit_time_s"}:
            raise AssertionError(f"return_fields gave {sorted(resp)}")
        if name == "int8":
            tol = np.maximum(np.abs(full["lam"]).max(axis=1, keepdims=True),
                             1.0) / 127 * 0.51
            if not (np.abs(resp["lam"] - full["lam"]) <= tol).all():
                raise AssertionError("int8 lam beyond half a code step")
        log(f"served fit, {name}: median of 3 {out[name]['wall_s']:.4f} s "
            f"{[round(w, 4) for w in walls]} at the client, "
            f"{out[name]['server_s']:.4f} s in the server's handler; "
            f"request {out[name]['bytes_in']:,} bytes, response "
            f"{out[name]['bytes_out']:,} bytes")
    return out


def served_stream(served, host, stim, name, lo, hi, create=None):
    """Blocks lo..hi-1 of phase 19's stream over /stream/<name>/update;
    returns each update's latency at the client, ms."""
    edges = [b * STREAM_TRIALS for b in range(STREAM_BLOCKS + 1)]
    times = []
    for blk in range(lo, hi):
        a, b = edges[blk], edges[blk + 1]
        t0 = time.perf_counter()
        served.stream_update(name, host[a:b], stim[:, a:b], iters=10,
                             demix=False,
                             create=create if blk == lo else None)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def start_cli_server(state_dir):
    """``python -m circuitmap_torch serve --port 0 --state-dir`` (CUDA);
    returns (Popen, FitClient, SERVING line)."""
    import select

    from circuitmap_torch import serve as ts

    env = cli_env()
    err = open(Path(state_dir) / "server_stderr.log", "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "circuitmap_torch", "serve", "--port", "0",
         "--state-dir", str(state_dir)], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    deadline = time.time() + 180
    while time.time() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                break
            continue
        line = proc.stdout.readline()
        if line.startswith("SERVING"):
            port = int(line.split("port=")[1].split()[0])
            return proc, ts.FitClient(f"http://127.0.0.1:{port}",
                                      timeout=600), line.strip()
        if not line:
            break
    proc.kill()
    raise AssertionError("the CLI server printed no SERVING line: "
                         + (Path(state_dir) / "server_stderr.log").read_text()[-3000:])


def stop_process(proc, how):
    """End a CLI server (``how``: "sigterm", "kill", or "wait" for one
    that was asked to shut down); returns its exit code and the rest of
    its standard output."""
    import signal

    if proc.poll() is None:
        if how == "sigterm":
            proc.send_signal(signal.SIGTERM)
        elif how == "kill":
            proc.kill()
    out, _ = proc.communicate(timeout=120)
    return proc.returncode, out


def demix_determinism(sim):
    """Phase 26's first step: the int4d2 demix of the main map with the
    demixer's deterministic cuDNN algorithms (what it runs) and with
    cuDNN's default ones, 4 pairs in turns. The deterministic outputs
    must agree bit for bit; returns the medians (s) and the default
    algorithms' largest difference from them."""
    import torch
    from circuitmap_torch import NeuralDemixer

    dm = NeuralDemixer(str(CHECKPOINT))
    chosen = dm._precision

    def default_algorithms(deterministic=False):
        return chosen(False)

    times = {"deterministic": [], "default": []}
    outs = {"deterministic": [], "default": []}
    for _ in range(2):
        for kind in ("default", "deterministic", "deterministic", "default"):
            dm._precision = (chosen if kind == "deterministic"
                             else default_algorithms)
            out, s = timed(lambda: dm(sim["psc"], keep_on_device=True,
                                      transfer_dtype="int4d2", verbose=False))
            times[kind].append(s)
            outs[kind].append(out)
    ref = outs["deterministic"][0]
    if not all(torch.equal(o, ref) for o in outs["deterministic"]):
        raise AssertionError("the deterministic demix differs run to run")
    spread = max(float((o - ref).abs().max()) for o in outs["default"])
    rec = dict(deterministic_s=statistics.median(times["deterministic"]),
               default_s=statistics.median(times["default"]),
               default_max_abs_diff=spread)
    log(f"int4d2 demix of the map, 4 pairs in turns: deterministic cuDNN "
        f"algorithms (the demixer's) median {rec['deterministic_s']:.4f} s, "
        f"cuDNN's default ones {rec['default_s']:.4f} s; the default "
        f"algorithms' outputs part from the deterministic one by up to "
        f"{spread:.3e}")
    return rec


def phase_serve(sim, dem, main_e2e_s, stream_steady_ms):
    """Phase 26: the fit server at the main path's width. First the
    demixer's determinism (``demix_determinism``): a served result can
    equal the in-process chain only if two demixes of one block agree.
    In process (CUDA, a thread, port 0): /health; /warm at [[1000, 20000]]; /fit
    with the raw PSC on the int4d2 wire, sparse stim and demix=true
    against the in-process chain (1e-6 relative, truth-R2 >= 0.98, the
    chain's launches); the same request with return_fields and with the
    int8 lam wire (wall, bytes); /fit_many on phase 10's folds, batched,
    against caviar_many; phase 19's 10-block stream over HTTP against an
    in-process OnlineCaviar. Then the CLI server in a subprocess: 5
    blocks, SIGTERM (exit 0, the stream saved), a second server loads it
    and takes 5 more blocks, equal to the uninterrupted stream."""
    import tempfile

    import torch
    from circuitmap_torch import (Model, NeuralDemixer, OnlineCaviar,
                                  caviar_many, default_priors)
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 26: the fit server, in process on a thread (CUDA, port 0, "
        "the int4d2 QAT demixer), then `python -m circuitmap_torch serve` "
        "in a subprocess")
    paths, rec = {}, {}
    rec["demix"] = demix_determinism(sim)
    stim = sim["stim_matrix"]
    opts = dict(iters=50, msrmp=0.3, powers=list(POWERS), seed=0)
    served = ServedPhase()
    cli = served.client
    try:
        health = cli.health()
        log(f"/health: device {health['device']!r}, platform "
            f"{health['platform']!r}")
        if health["platform"] != "gpu" or \
                health["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"/health does not name the card: {health}")

        warm, warm_s, _ = served.timed_request(
            lambda: cli.warm([[N, K]], iters=50, powers=list(POWERS)))
        rec["warm_s"], rec["warm_server_s"] = warm_s, warm["warmed"]
        log(f"/warm at [[{N}, {K}]]: {warm_s:.3f} s at the client "
            f"(server: {warm['warmed']})")

        from circuitmap_torch.serve import FitClient

        encode = []
        for _ in range(3):
            t0 = time.perf_counter()
            FitClient._body(sim["psc"], stim, True, "int4d2")
            encode.append(time.perf_counter() - t0)
        rec["client_encode_s"] = statistics.median(encode)
        log(f"the client's int4d2 + sparse-stim body: median of 3 "
            f"{rec['client_encode_s']:.4f} s on the host")
        reset_counts()
        full, first_s, _ = served.timed_request(
            lambda: cli.fit(sim["psc"], stim, psc_wire="int4d2", demix=True,
                            trace_wire="int4d2", **opts))
        paths["served_fit"] = kernel_launches(read_counts())
        reset_counts()
        chain = Model(N).fit(
            NeuralDemixer(str(CHECKPOINT))(
                sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
                verbose=False),
            stim, method="caviar", fit_options=dict(opts, verbose=False))
        torch.cuda.synchronize()
        chain_launches = kernel_launches(read_counts())
        d_fit = max_rel_diff(full, chain.state, FIT_FIELDS)
        r2 = r2_score(sim["weights"], full["mu"])
        log(f"/fit (int4d2 body, sparse stim, demix, 50 iterations): first "
            f"{first_s:.3f} s; launches {paths['served_fit']} (in-process "
            f"chain {chain_launches}); largest relative difference from the "
            f"in-process chain {d_fit:.3e}; truth-R2 {r2:.4f}")
        if d_fit > 1e-6:
            raise AssertionError(f"served fit differs by {d_fit:.3e}")
        if r2 < 0.98:
            raise AssertionError(f"served truth-R2 {r2:.4f} < 0.98")
        if paths["served_fit"] != chain_launches or \
                paths["served_fit"]["sweep_blocked"] != 50:
            raise AssertionError("the served fit must launch what the "
                                 f"chain launches: {paths['served_fit']}")
        rec.update(first_fit_s=first_s, fit_rel_diff=d_fit, r2=r2,
                   main_path_e2e_s=main_e2e_s)
        rec["fit"] = served_variants(served, sim, opts, full)
        log(f"served fit median {rec['fit']['full']['wall_s']:.4f} s "
            f"(return_fields {rec['fit']['return_fields']['wall_s']:.4f} s, "
            f"int8 lam {rec['fit']['int8']['wall_s']:.4f} s) against phase "
            f"5's in-process end to end {main_e2e_s:.4f} s")
        del full, chain

        q = K // 4
        keeps = [np.r_[0:f * q, (f + 1) * q:K] for f in range(4)]
        raw = np.stack([sim["psc"][kp] for kp in keeps])
        stims = np.stack([stim[:, kp] for kp in keeps])
        many_opts = dict(iters=50, msrmp=0.3, powers=list(POWERS),
                         compile_mode="batched")
        reset_counts()
        got, many_s, line = served.timed_request(
            lambda: cli.fit_many(raw, stims, psc_wire="int4d2", demix=True,
                                 trace_wire="int4d2", **many_opts))
        m_in, m_out = line["bytes_in"], line["bytes_out"]
        paths["served_fit_many"] = kernel_launches(read_counts())
        flat = NeuralDemixer(str(CHECKPOINT))(
            raw.reshape(-1, raw.shape[-1]), keep_on_device=True,
            transfer_dtype="int4d2", verbose=False)
        p = default_priors(N)
        ref = caviar_many(flat.reshape(4, q * 3, -1), stims, p["mu"],
                          p["beta"], p["shape"], p["rate"], p["phi"],
                          p["phi_cov"], verbose=False, **many_opts)
        d_many = max(max_rel_diff({k: v[f] for k, v in got.items()}, ref[f],
                                  FIT_FIELDS) for f in range(4))
        log(f"/fit_many, 4 folds batched (int4d2 body, demix): {many_s:.3f} s"
            f" at the client, {line['seconds']:.3f} s in the server's handler;"
            f" request {m_in:,} bytes, response {m_out:,} bytes; launches "
            f"{paths['served_fit_many']}; largest relative difference from "
            f"in-process caviar_many {d_many:.3e}")
        if d_many > 1e-6:
            raise AssertionError(f"served fit_many differs by {d_many:.3e}")
        if paths["served_fit_many"]["sweep_row"] != 50 or \
                paths["served_fit_many"]["laplace"] < 50:
            raise AssertionError("served fit_many must launch the batched "
                                 "row kernel 50 times and Laplace at least "
                                 f"50: {paths['served_fit_many']}")
        rec["fit_many"] = dict(s=many_s, server_s=line["seconds"],
                               bytes_in=m_in, bytes_out=m_out,
                               rel_diff=d_many)
        del got, ref, flat, raw, stims

        host = dem.cpu().numpy()
        create = {"powers": list(POWERS)}
        reset_counts()
        times = served_stream(cli, host, stim, "served", 0, STREAM_BLOCKS,
                              create)
        paths["served_stream"] = kernel_launches(read_counts())
        served_res = cli.stream_result("served")
        local = OnlineCaviar(N, powers=list(POWERS))
        edges = [b * STREAM_TRIALS for b in range(STREAM_BLOCKS + 1)]
        for a, b in zip(edges[:-1], edges[1:]):
            local.update(host[a:b], stim[:, a:b], iters=10)
        want = local.result()
        d_stream = max_rel_diff(served_res, want, FIT_FIELDS)
        steady = statistics.median(times[3:])
        log(f"stream over HTTP, {STREAM_BLOCKS} blocks of {STREAM_TRIALS} "
            f"trials: update ms at the client "
            + ", ".join(f"{t:.1f}" for t in times)
            + f"; steady median (blocks 4-10) {steady:.1f} ms against phase "
            f"19's in-process {stream_steady_ms:.1f} ms; launches "
            f"{paths['served_stream']}; largest relative difference from "
            f"the in-process stream {d_stream:.3e}")
        if d_stream > 1e-6:
            raise AssertionError(f"served stream differs by {d_stream:.3e}")
        if paths["served_stream"]["sweep_blocked"] != 10 * STREAM_BLOCKS:
            raise AssertionError("the served stream must launch B1 10 times "
                                 f"a block: {paths['served_stream']}")
        rec["stream"] = dict(block_ms=times, steady_median_ms=steady,
                             in_process_steady_median_ms=stream_steady_ms,
                             rel_diff=d_stream)
    finally:
        served.close()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        proc, sub, line = start_cli_server(tmp)
        try:
            start_s = time.time() - t0
            log(f"CLI server up in {start_s:.1f} s: {line}")
            served_stream(sub, host, stim, "cli", 0, 5, create)
            code, out = stop_process(proc, "sigterm")
            saved = Path(tmp) / "cli.npz"
            log(f"SIGTERM after 5 blocks: exit {code}; "
                f"{[x for x in out.splitlines() if x.startswith('stream')]}")
            if code != 0 or not saved.exists():
                raise AssertionError("SIGTERM must exit 0 and save the "
                                     f"stream (exit {code}, saved "
                                     f"{saved.exists()})")
            proc, sub, line = start_cli_server(tmp)
            loaded = sub.stream_load("cli", create=create)
            served_stream(sub, host, stim, "cli", 5, STREAM_BLOCKS)
            resumed = sub.stream_result("cli")
            sub.shutdown()
            code, _ = stop_process(proc, "wait")
        finally:
            if proc.poll() is None:
                stop_process(proc, "kill")
    d_restart = max_rel_diff(resumed, want, FIT_FIELDS)
    log(f"restarted server loaded {loaded}, took blocks 6-10, exit {code} "
        f"after /shutdown; largest relative difference from the "
        f"uninterrupted stream {d_restart:.3e}")
    if d_restart > 1e-6 or code != 0:
        raise AssertionError(f"restarted stream differs by {d_restart:.3e} "
                             f"(exit {code})")
    rec["restart"] = dict(first_start_s=start_s, rel_diff=d_restart)
    return paths, rec


# phase 27: the multi-device layer (trial-sharded and multi-process fits,
# the mesh= entry points) on one card
WITNESS_ITERS = 3  # phase 27's float64 witnesses' depth (on CPU shards)
GLOO_ITERS = 20    # phase 27 (b)'s fit in two gloo processes
MESH_STREAM_BLOCKS = 5  # phase 27 (d)'s stream: the first 5 of phase 19's blocks
MESH_OPTS = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
             "verbose": False, "sweep_block_size": 8}
WITNESS = dict(iters=WITNESS_ITERS, update_order="identity",
               analytic_mc=True, sweep_block_size=8, msrmp=0.3,
               powers=list(POWERS), fn_scan=False, verbose=False)
GLOO_SPLIT = 10001  # rank 0's trials; rank 1 holds the other 9,999
CARD = "cuda:0"


def card_mesh():
    """Two trial shards on the one card."""
    from circuitmap_torch.parallel import trial_mesh

    return trial_mesh(devices=[CARD] * 2)


def gloo_worker(rank, port, tmp, card):
    """One of two processes on cuda:0 joined by gloo (NCCL refuses two
    ranks on one card): its half of the main map's trials, the float32
    fit at the main path's options, then the float64 identity witness on
    a CPU shard in the same group. Rank 0 writes the gathered results."""
    import os

    import torch

    sys.path.insert(0, str(HERE))
    from circuitmap_torch import parallel

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    data = np.load(f"{tmp}/rank{rank}.npz")
    priors = [data[f"prior{i}"] for i in range(6)]
    parallel.initialize_distributed(f"tcp://localhost:{port}", world_size=2,
                                    rank=rank, backend="gloo", device=card)
    from circuitmap_torch.ops.laplace_cuda import laplace_from_stats

    mesh = parallel.global_trial_mesh(devices=[card])
    laplace_from_stats.launches = laplace_from_stats.launches_f64 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = parallel.caviar_sharded_distributed(
        data["psc"], data["stim"], *priors, mesh=mesh,
        **dict(MESH_OPTS, iters=GLOO_ITERS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(wall_s=wall, all_reduces=mesh.all_reduces,
               all_reduce_s=mesh.all_reduce_s,
               laplace_launches=laplace_from_stats.launches)
    cpu = parallel.global_trial_mesh(devices=["cpu"])
    wkw = {k: v for k, v in WITNESS.items() if k != "fn_scan"}
    wit = parallel.caviar_sharded_distributed(
        data["psc"].astype(np.float64), data["stim"], *priors, mesh=cpu,
        dtype=torch.float64, **wkw)
    if rank == 0:
        np.savez(f"{tmp}/result.npz", **{f"f32_{f}": np.asarray(v) for f, v
                                          in zip(FIT_FIELDS, out[:8])},
                 **{f"f64_{f}": np.asarray(v) for f, v
                    in zip(FIT_FIELDS, wit[:8])})
    with open(f"{tmp}/rank{rank}.json", "w") as fh:
        json.dump(rec, fh)
    torch.distributed.destroy_process_group()


def run_gloo_pair(sim, dem, limit_s=240):
    """Phase 27b's two processes (spawned, each with its half of the
    trials); returns (rank records, rank 0's results)."""
    import os
    import socket
    import tempfile

    import torch.multiprocessing as mp
    from circuitmap_torch import default_priors

    p = default_priors(N)
    priors = [p[k] for k in ("mu", "beta", "shape", "rate", "phi",
                             "phi_cov")]
    host = dem.cpu().numpy()
    stim = np.asarray(sim["stim_matrix"], np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        for rank, (a, b) in enumerate(((0, GLOO_SPLIT), (GLOO_SPLIT, K))):
            np.savez(f"{tmp}/rank{rank}.npz", psc=host[a:b],
                     stim=stim[:, a:b],
                     **{f"prior{i}": v for i, v in enumerate(priors)})
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        # gloo's pairs on the loopback interface only (it would otherwise
        # take the interface the host name resolves to)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        ctx = mp.spawn(gloo_worker, args=(port, tmp, CARD), nprocs=2,
                       join=False)
        deadline = time.time() + limit_s
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError(f"the two gloo processes did not end "
                                     f"in {limit_s} s")
        recs = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(2)]
        res = dict(np.load(f"{tmp}/result.npz"))
    return recs, res


def gate_check(a, b, what, rtol=2e-3):
    """The same gate pattern (mu != 0) and mu within ``rtol``, as the
    JAX package's sharded test holds a mesh fit to the single one."""
    ma, mb = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
              for x in (a, b))
    flips = int(np.sum((ma != 0) != (mb != 0)))
    close = np.allclose(ma, mb, rtol=rtol, atol=rtol)
    log(f"{what}: {flips} gate flips; mu within rtol {rtol}: {close}")
    if flips or not close:
        raise AssertionError(f"{what}: {flips} gate flips, mu close {close}")


def witness_floor(host64, sim, single64):
    """How far the unsharded float64 witness fit moves when only the
    order of its trial sums changes: the same fit over the trials in a
    fixed random order (lam and z put back), as ``max_rel_diff`` over
    mu, lam, phi. The Gram's Cholesky and the Laplace Hessian amplify
    float64 rounding to ~1e-9 at N=1000, so a sharded fit, which sums
    the trials in shards, can be held no tighter than this."""
    import torch
    from circuitmap_torch import caviar

    perm = np.random.default_rng(1).permutation(K)
    sim_p = dict(sim, stim_matrix=sim["stim_matrix"][:, perm])
    out = fit_dict(caviar(*caviar_args(host64[perm], sim_p), device="cpu",
                          dtype=torch.float64, **WITNESS))
    out["lam"] = out["lam"][:, np.argsort(perm)]
    return max_rel_diff(out, single64, ("mu", "lam", "phi"))


def phase_mesh(sim, dem, main, online_steady_ms):
    """Phase 27: the multi-device layer on one card (cuda:0), N=1000,
    K=20000, the demixed main map.

    (a) ``Model.fit(mesh=)`` over two shards of the card, 50 iterations
    at block 8 (phase 5's fit, ``main``, on the same random stream and
    schedule): truth-R2 within 0.003 of phase 5's, its gate pattern and
    mu beside phase 5's, B2 once an iteration (plus the reconnection
    refit), the sweep kernels never; the collectives; the warm wall
    time; one iteration under the profiler (idle share); the float64
    identity witness on two CPU shards equal to the unsharded float64
    fit to max(1e-9, 3x the unsharded fit's own reassociation spread:
    the same fit over the trials in another order, ``witness_floor``).
    (b) two processes on cuda:0
    joined by gloo, uneven halves (10,001 and 9,999 trials): the float32
    fit (GLOO_ITERS iterations) against (a)'s mesh fit at as many
    iterations without the reconnection scan (gate
    pattern, mu within 2e-3), their all-reduces, and the float64 witness
    (CPU shards) to (a)'s bound. (c) ``caviar_many`` (batched, block 1) and
    ``sns_many`` on phase 10's 4 folds over the two shards against their
    unsharded batched fits: the same gates, 1e-5 (float32 sums grouped
    by the stack's size). (d) ``caviar_resumable(mesh=)`` in
    segments of 10, resumed from 20, against the straight sharded fit
    bit for bit; ``OnlineCaviar(mesh=)`` over the first
    MESH_STREAM_BLOCKS of phase 19's blocks with the per-block latency,
    against the unsharded stream over the same blocks. (e) the
    demixer's meshed call against its unsharded call (1e-6) and a
    ``FitService(mesh_devices=2, device="cuda:0")`` served ``/fit``
    against (a)."""
    import json as _json
    import tempfile

    import torch
    from circuitmap_torch import (Model, NeuralDemixer, OnlineCaviar,
                                  caviar, caviar_many, caviar_resumable,
                                  default_priors, serve as ts, sns_many)
    from circuitmap_torch.parallel import caviar_sharded, trial_mesh
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 27: trial-sharded and multi-process fits on one card "
        "(2 shards on cuda:0; 2 gloo processes on cuda:0)")
    paths, rec = {}, {}
    stim = sim["stim_matrix"]
    mesh = card_mesh()

    # (a) the trial-sharded main-path fit
    def fit():
        return Model(N).fit(dem, stim, fit_options=dict(MESH_OPTS, mesh=mesh))

    reset_counts()
    mesh.reset_counts()
    model, first_s = timed(fit)
    paths["mesh_fit"] = kernel_launches(read_counts())
    psums, n_ar = mesh.psums, mesh.all_reduces
    r2 = r2_score(sim["weights"], model.state["mu"])
    main_r2 = r2_score(sim["weights"], main.state["mu"])
    warm = timed(fit)[1]
    log(f"(a) Model.fit(mesh=2 shards on cuda:0), 50 iterations at block 8:"
        f" first {first_s:.3f} s, warm {warm:.3f} s; launches "
        f"{paths['mesh_fit']};"
        f" {psums} psums ({psums / 50:.1f} an iteration), {n_ar} all-reduces;"
        f" truth-R2 {r2:.6f} against phase 5's {main_r2:.6f}")
    if abs(r2 - main_r2) > 0.003:
        raise AssertionError(f"sharded truth-R2 {r2:.4f} is not within 0.003"
                             f" of the unsharded {main_r2:.4f}")
    flips = int(np.sum((model.state["mu"] != 0) != (main.state["mu"] != 0)))
    d_main = max_rel_diff(model.state, main.state, ("mu",))
    log(f"(a) beside phase 5's fit (the cluster kernel's sums): {flips} "
        f"gate flips, mu {d_main:.3e} relative")
    lp = paths["mesh_fit"]
    if lp["laplace"] not in (50, 51) or lp["sweep_blocked"] or \
            lp["sweep_row"]:
        raise AssertionError(f"the sharded fit must launch B2 50 or 51 "
                             f"times and no sweep kernel: {lp}")
    one = dict(MESH_OPTS, iters=1, mesh=mesh)
    rows = profiled(lambda: Model(N).fit(dem, stim, fit_options=one),
                    "sharded_fit_1_iteration")
    rec["a"] = dict(first_s=first_s, warm_s=warm, r2=r2, main_r2=main_r2,
                    gate_flips_vs_main=flips, mu_rel_diff_vs_main=d_main,
                    psums_per_iter=psums / 50,
                    profiled=rows is not None)

    host64 = dem.cpu().double().numpy()
    args64 = caviar_args(host64, sim)
    single64, s64_s = timed(lambda: caviar(
        *args64, device="cpu", dtype=torch.float64, **WITNESS))
    single64 = fit_dict(single64)
    shard64, m64_s = timed(lambda: caviar_sharded(
        *args64, mesh=trial_mesh(devices=["cpu"] * 2), dtype=torch.float64,
        **WITNESS))
    d64 = max_rel_diff(fit_dict(shard64), single64, ("mu", "lam", "phi"))
    floor = witness_floor(host64, sim, single64)
    bound = max(1e-9, 3 * floor)
    log(f"(a) float64 identity witness, {WITNESS_ITERS} iterations on 2 CPU "
        f"shards ({m64_s:.1f} s) against the unsharded CPU fit "
        f"({s64_s:.1f} s): largest relative difference {d64:.3e}; the "
        f"unsharded fit over the trials in another order differs from "
        f"itself by {floor:.3e}; bound {bound:.3e}")
    if d64 > bound:
        raise AssertionError(f"float64 sharded witness differs by {d64:.3e}")
    rec["a"].update(witness64_rel_diff=d64, witness64_floor=floor)

    # (b) two processes on the card under gloo
    nosc, _ = timed(lambda: caviar_sharded(
        *caviar_args(dem, sim), mesh=mesh, fn_scan=False,
        **dict(MESH_OPTS, iters=GLOO_ITERS)))
    (r0, r1), res = run_gloo_pair(sim, dem)
    got = {f: res[f"f32_{f}"] for f in FIT_FIELDS}
    gate_check(got["mu"], nosc[0], "(b) 2 gloo processes vs (a)'s mesh fit")
    d_b = max_rel_diff(got, fit_dict(nosc), FIT_FIELDS)
    wit = {f: res[f"f64_{f}"] for f in FIT_FIELDS}
    d_b64 = max_rel_diff(wit, single64, ("mu", "lam", "phi"))
    log(f"(b) ranks' fit {r0['wall_s']:.3f} / {r1['wall_s']:.3f} s; "
        f"all-reduces {r0['all_reduces']} "
        f"({r0['all_reduces'] / GLOO_ITERS:.1f} an "
        f"iteration), {r0['all_reduce_s']:.3f} / {r1['all_reduce_s']:.3f} s "
        f"in them ({r0['all_reduce_s'] / r0['all_reduces'] * 1e6:.1f} us "
        f"each on rank 0); B2 launches {r0['laplace_launches']} / "
        f"{r1['laplace_launches']}; largest relative difference from (a)'s "
        f"mesh fit {d_b:.3e}; float64 witness {d_b64:.3e}")
    if d_b64 > bound:
        raise AssertionError(f"float64 gloo witness differs by {d_b64:.3e}")
    rec["b"] = dict(ranks=[r0, r1], rel_diff=d_b, witness64_rel_diff=d_b64)

    # (c) experiment-sharded fits
    ys, stims = fold_stack(sim, dem)
    p = default_priors(N)
    cp = [p[k] for k in ("mu", "beta", "shape", "rate", "phi", "phi_cov")]
    sp = [p[k] for k in ("mu", "beta", "alpha", "shape", "rate", "phi",
                         "phi_cov")]
    mkw = dict(iters=50, msrmp=0.3, powers=list(POWERS), verbose=False,
               compile_mode="batched", device=CARD)
    skw = dict(iters=SNS_MANY_ITERS, powers=list(POWERS), verbose=False,
               compile_mode="batched", device=CARD)
    want = caviar_many(ys, stims, *cp, **mkw)
    reset_counts()
    got, many_s = timed(lambda: caviar_many(ys, stims, *cp, mesh=mesh,
                                            **mkw))
    paths["caviar_many_mesh"] = kernel_launches(read_counts())
    d_many = max(max_rel_diff(g, w, FIT_FIELDS) for g, w in zip(got, want))
    many_flips = sum(int(np.sum((g["mu"] != 0) != (w["mu"] != 0)))
                     for g, w in zip(got, want))
    want = sns_many(ys, stims, *sp, **skw)
    reset_counts()
    got, sns_s = timed(lambda: sns_many(ys, stims, *sp, mesh=mesh, **skw))
    paths["sns_many_mesh"] = kernel_launches(read_counts())
    d_sns = max(max_rel_diff(g, w, g.keys()) for g, w in zip(got, want))
    log(f"(c) caviar_many(mesh=), 4 folds over 2 shards, batched block 1: "
        f"{many_s:.3f} s, launches {paths['caviar_many_mesh']}, largest "
        f"relative difference {d_many:.3e}, {many_flips} gate flips; "
        f"sns_many(mesh=) ({SNS_MANY_ITERS} iterations) {sns_s:.3f} s, "
        f"launches {paths['sns_many_mesh']}, {d_sns:.3e}")
    # a chunk of 2 experiments runs the batched algebra at E=2 where the
    # unsharded fit runs it at E=4: batched GEMMs and reductions group
    # their float32 sums by the stack's size (PERF.md §6)
    if many_flips or max(d_many, d_sns) > 1e-5:
        raise AssertionError(f"experiment-sharded fits differ: {d_many:.3e},"
                             f" {d_sns:.3e}, {many_flips} gate flips")
    rec["c"] = dict(caviar_many_s=many_s, sns_many_s=sns_s,
                    caviar_many_rel_diff=d_many, sns_many_rel_diff=d_sns)
    del ys, got, want

    # (d) resumable and streaming fits over the mesh
    args = caviar_args(dem, sim)
    rkw = {k: v for k, v in MESH_OPTS.items() if k != "iters"}
    straight = caviar_sharded(*args, mesh=mesh, iters=30, **rkw)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        caviar_resumable(*args, f"{tmp}/fit", mesh=mesh, iters=20,
                         checkpoint_every=10, **rkw)
        resumed, res_s = timed(lambda: caviar_resumable(
            *args, f"{tmp}/fit", mesh=mesh, iters=30, checkpoint_every=10,
            **rkw))
        paths["resumable_mesh"] = kernel_launches(read_counts())
    same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(resumed[:8], straight[:8]))
    log(f"(d) caviar_resumable(mesh=) stopped after 20 iterations and "
        f"resumed to 30 ({res_s:.3f} s for the last 10): bit for bit the "
        f"straight fit: {same}; launches {paths['resumable_mesh']}")
    if not same:
        raise AssertionError("the resumed sharded fit is not the straight "
                             "one bit for bit")

    host = dem.cpu().numpy()
    edges = [b * STREAM_TRIALS for b in range(MESH_STREAM_BLOCKS + 1)]
    okw = dict(powers=list(POWERS), update_order="identity",
               analytic_mc=True, device=CARD)

    def stream(**kw):
        oc, times = OnlineCaviar(N, **okw, **kw), []
        for a, b in zip(edges[:-1], edges[1:]):
            t0 = time.perf_counter()
            oc.update(host[a:b], stim[:, a:b], iters=10)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return oc.result(), times

    plain, _ = stream()
    reset_counts()
    meshed, times = stream(mesh=mesh)
    paths["online_mesh"] = kernel_launches(read_counts())
    d_stream = max_rel_diff(meshed, plain, FIT_FIELDS)
    steady = statistics.median(times[3:])
    log(f"(d) OnlineCaviar(mesh=) over the first {MESH_STREAM_BLOCKS} of "
        f"phase 19's blocks (identity "
        f"order, exact means): update ms per block "
        + ", ".join(f"{t:.1f}" for t in times)
        + f"; steady median {steady:.1f} ms against phase 19's unsharded "
        f"{online_steady_ms:.1f} ms; launches {paths['online_mesh']}; "
        f"largest relative difference from the unsharded stream "
        f"{d_stream:.3e}")
    gate_check(meshed["mu"], plain["mu"], "(d) meshed vs unsharded stream")
    rec["d"] = dict(resumed_bitwise=same, stream_block_ms=times,
                    stream_steady_ms=steady, stream_rel_diff=d_stream)

    # (e) the demixer and the server over the mesh
    demixer = NeuralDemixer(str(CHECKPOINT), device=CARD)
    reset_counts()
    dm, dm_s = timed(lambda: demixer(
        sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
        verbose=False, mesh=mesh))
    d_dm = max_rel_diff({"x": dm}, {"x": dem}, ("x",))
    svc = ts.FitService(mesh_devices=2, device=CARD)
    body = ts._npz_bytes(psc=host, stim=stim)
    opts = {k: v for k, v in MESH_OPTS.items() if k != "verbose"}
    reset_counts()
    served, srv_s = timed(lambda: ts._load_npz(svc.do_fit(
        body, _json.dumps(dict(opts, demix=False)))[1]))
    paths["served_mesh_fit"] = kernel_launches(read_counts())
    d_srv = max_rel_diff(served, model.state, FIT_FIELDS)
    log(f"(e) demixer(mesh=) {dm_s:.3f} s, largest relative difference "
        f"from the unsharded demix {d_dm:.3e}; FitService(mesh_devices=2) "
        f"/fit {srv_s:.3f} s, launches {paths['served_mesh_fit']}, largest "
        f"relative difference from (a) {d_srv:.3e}")
    if max(d_dm, d_srv) > 1e-6:
        raise AssertionError(f"meshed demix / served fit differ: {d_dm:.3e}"
                             f", {d_srv:.3e}")
    rec["e"] = dict(demix_s=dm_s, demix_rel_diff=d_dm, served_s=srv_s,
                    served_rel_diff=d_srv)
    return paths, rec


# -- phase 28: the workflow commands ------------------------------------

WF_FIELDS = ("mu", "beta", "lam", "phi")  # a command's posterior, held
WF_RTOL = 1e-6
GRID_SIDE = (25, 20)     # phase 28's grid: 2 planes of 25 x 20 locations
MIN_SPIKES = 3           # caviar's minimum_spike_count: the gate's floor
FANOUT_JOBS = 2


def cli_command(name, argv):
    """``python -m circuitmap_torch <name> argv`` in this process (what
    it prints is kept aside). Returns (printed text, seconds, launches
    per kernel from 0)."""
    import contextlib
    import io

    import torch
    from circuitmap_torch.__main__ import main as cli

    buf = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli([name, *map(str, argv)])
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = kernel_launches(read_counts())
    if rc != 0:
        raise AssertionError(f"{name} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue(), secs, launches


def cli_env():
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return env


def hold_fit_launches(launches, what, fits, iters, sns_fits=0):
    """``fits`` CAVIaR fits of ``iters`` iterations at 8 rows a step
    (B1 once an iteration, B2 once an iteration and once more when the
    reconnection scan refits) and ``sns_fits`` CAVI-SnS fits (B3 and B2
    once an iteration)."""
    b1, b2, b3 = (launches[k] for k in ("sweep_blocked", "laplace",
                                        "sweep_row"))
    lo = (fits + sns_fits) * iters
    require_launches(
        b1 == fits * iters and b3 == sns_fits * iters and
        lo <= b2 <= lo + fits, what, launches,
        f"B1 {fits * iters}, B3 {sns_fits * iters}, B2 {lo}..{lo + fits}")


def require_launches(ok, what, launches, expected):
    if not ok:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{expected}")


def hold_equal(got, want, what, fields=WF_FIELDS):
    """A command's posterior against its in-process counterpart's, and
    no NaN in it."""
    for f in fields:
        if np.isnan(np.asarray(got[f], np.float64)).any():
            raise AssertionError(f"{what}: {f} holds a NaN")
    d = max_rel_diff(got, want, fields)
    same = all(np.array_equal(np.asarray(got[f]), np.asarray(want[f]))
               for f in fields)
    if d > WF_RTOL:
        raise AssertionError(f"{what}: {d:.3e} from its in-process "
                             f"counterpart (> {WF_RTOL})")
    return d, same


def hold_r2(weights, mu, what, floor=0.98):
    from circuitmap_torch.utils.metrics import r2_score

    r2 = r2_score(weights, mu)
    if floor is not None and r2 < floor:
        raise AssertionError(f"{what}: truth-R2 {r2:.4f} < {floor}")
    return r2


def save_expt(path, psc, stim, key="stimulus_matrix"):
    np.savez(path, psc=np.asarray(psc, np.float32),
             **{key: np.asarray(stim, np.float32)})


LOHO_OPTS = {"iters": 50, "msrmp": 0.3, "save_histories": False,
             "verbose": False}  # loho-cv's fit at its defaults


def loho_mse(state, psc_test, stim_test):
    """The held-out charges' MSE under a fold's fit, as the JAX script
    computes it (scripts_tpu/run_loho_cv.py:68-82)."""
    mu, phi = state["mu"], state["phi"]
    drive = phi[:, 0:1] * stim_test - phi[:, 1:2]
    y_hat = mu @ (1.0 / (1.0 + np.exp(-drive)) * (stim_test > 0))
    return float(np.mean((np.trapezoid(psc_test, axis=-1) - y_hat) ** 2))


def wf_loho(tmp, rec, paths):
    """loho-cv (2 folds in process) and fanout-jobs (bash, its script cut
    to the same 2 folds: each fold a ``python -m circuitmap_torch loho-cv
    --fold I`` worker in a subprocess) on an experiment whose holograms
    repeat twice."""
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.parallel.sweep import loho_folds
    from circuitmap_torch.simulation import blockwise_design

    np.random.seed(1)
    stim = blockwise_design(N, H, K, POWERS, nreps=2)
    lsim = simulate(N=N, trials=K, H=H, connection_prob=0.05,
                    stim_matrix=stim, batch_size=1000, verbose=False)
    data = f"{tmp}/loho.npz"
    save_expt(data, lsim["psc"], stim)
    folds = list(loho_folds(np.asarray(stim, np.float32).astype(float)))
    common = ["--data", data, "--demixer", CHECKPOINT]
    out, secs, launches = cli_command(
        "loho-cv", common + ["--max_folds", 2, "--out", f"{tmp}/cv.json"])
    paths["cmd_loho_cv"] = launches
    hold_fit_launches(launches, "loho-cv", fits=2, iters=50)
    sweep = json.load(open(f"{tmp}/cv.json"))
    # each fold in process: the library's demix and fit of the same trials
    psc = np.load(data)["psc"].astype(float)
    dem = NeuralDemixer(str(CHECKPOINT))(psc, verbose=False)
    for (holo, train, test), got in zip(folds, sweep):
        model = Model(N).fit(dem[train], stim[:, train] * 1.0,
                             fit_options=LOHO_OPTS)
        mse = loho_mse(model.state, dem[test], stim[:, test])
        if got["hologram"] != holo or abs(got["held_out_mse"] - mse) > \
                WF_RTOL * abs(mse) or got["n_connections"] != int(
                    (model.state["mu"] != 0).sum()):
            raise AssertionError(f"loho-cv fold {holo} {got} is not the "
                                 f"in-process fit's (mse {mse})")
    log(f"loho-cv --max_folds 2 in process: {secs:.3f} s (load, int4d2-"
        f"checkpoint demix of {K} traces on the f32 wire, 2 fits); "
        f"launches {launches}; {len(folds)} folds in all; records "
        f"{[(r['hologram'], r['test_trials'], round(r['held_out_mse'], 6)) for r in sweep]};"
        f" each equal to the in-process fit's held-out MSE and connections")
    fout, fsecs, flaunch = cli_command(
        "fanout-jobs", common + ["--backend", "bash", "--out",
                                 f"{tmp}/fan.json", "--out-dir",
                                 f"{tmp}/jobs", "--jobs", FANOUT_JOBS])
    script = Path(f"{tmp}/jobs/run_loho_cv_fanout.sh")
    text = script.read_text()
    head = f"seq 0 {len(folds) - 1} |"
    if head not in text or "-m circuitmap_torch loho-cv" not in text:
        raise AssertionError(f"unexpected fan-out script:\n{text}")
    # the emitted script over the same 2 folds as the in-process sweep
    cut = Path(f"{tmp}/jobs/first_2_folds.sh")
    cut.write_text(text.replace(head, "seq 0 1 |"))
    t0 = time.time()
    proc = subprocess.run(["bash", str(cut)], cwd=tmp, env=cli_env(),
                          capture_output=True, text=True, timeout=300)
    bsecs = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"fan-out script failed: {proc.stderr[-3000:]}")
    fanned = [json.load(open(f"{tmp}/fan.json.fold_{i}.json"))
              for i in range(2)]
    if [len(f) for f in fanned] != [1, 1]:
        raise AssertionError(f"a --fold worker writes one record: {fanned}")
    hold_records([f[0] for f in fanned], sweep, "fan-out fold files")
    log(f"fanout-jobs --backend bash: {fsecs:.3f} s ({len(folds)} folds; "
        f"launches {flaunch}); the emitted script cut to folds 0-1 over "
        f"{FANOUT_JOBS} workers (`python -m circuitmap_torch loho-cv --fold "
        f"I` in subprocesses): {bsecs:.3f} s; their fold files equal the "
        f"sweep's records")
    require_launches(not any(fit_kernel_launches(flaunch).values()),
                     "fanout-jobs", flaunch, "no fit kernel")
    rec.update(loho_cv_s=secs, fanout_s=fsecs, fanout_script_s=bsecs,
               loho_folds=len(folds),
               loho_mse=[r["held_out_mse"] for r in sweep])
    return secs + fsecs + bsecs


def hold_records(got, want, what):
    for g, w in zip(got, want):
        for key in ("hologram", "test_trials", "n_connections"):
            if g[key] != w[key]:
                raise AssertionError(f"{what}: {key} {g[key]} != {w[key]}")
        if not np.isfinite(g["held_out_mse"]) or abs(
                g["held_out_mse"] - w["held_out_mse"]) > WF_RTOL * abs(
                    w["held_out_mse"]):
            raise AssertionError(f"{what}: {g} against {w}")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} records, not {len(want)}")


ONE_V_TEN_OPTS = {"msrmp": 0.3, "save_histories": False, "verbose": False}


def plain64_blocked_fit(psc, stim, opts):
    """``Model.fit`` at 8 rows a step with the cluster kernel swapped for
    the plain blocked sweep run in float64, on the same card and the
    same random streams (the sweep draws none); asserts that no sweep
    kernel launched."""
    import importlib

    import torch
    from circuitmap_torch import Model
    from circuitmap_torch.ops.sweep_cuda import sweep_spikes_blocked_torch

    cav = importlib.import_module("circuitmap_torch.solvers.caviar")

    def plain64(*a, **kw):
        wide = [x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in a]
        return sweep_spikes_blocked_torch(*wide, **kw).float()

    key = (False, False)  # the single fit's blocked sweep
    kernel_sweep, cav._SWEEPS[key] = cav._SWEEPS[key], plain64
    reset_counts()
    try:
        model = Model(N).fit(psc, stim, fit_options=opts)
    finally:
        cav._SWEEPS[key] = kernel_sweep
    launches = kernel_launches(read_counts())
    require_launches(not launches["sweep_blocked"], "the plain float64 fit",
                     launches, "no B1")
    return model


def wf_1v10(tmp, rec, paths):
    """pipeline-1v10's run step on a .mat of 10,000 single-target and
    10,000 10-target trials at N=1000, and its .mat export.

    Truth-R2 >= 0.98 holds for the ensemble fit (100 trials a cell). The
    single-target fit has 10 trials a cell: a connected cell of low
    excitability spikes in fewer than ``minimum_spike_count`` (3) of
    them, and the gate cannot pass it whatever the solver. The witness:
    the same fit with the plain blocked sweep in float64. When the
    witness too scores below 0.98, the single-target fit is held >= 0.98
    over the cells the data can reveal (those with at least 3 simulated
    spikes among its trials); otherwise it is held >= 0.98 over all."""
    from scipy.io import savemat

    from circuitmap_torch import Model, simulate
    from circuitmap_torch.scripts import run_1v10_pipeline as p1v10
    from circuitmap_torch.simulation import blockwise_design
    from circuitmap_torch.utils.metrics import r2_score

    np.random.seed(2)
    stim = np.hstack([blockwise_design(N, 1, K // 2, POWERS),
                      blockwise_design(N, H, K // 2, POWERS)])
    stim = stim[:, np.random.permutation(stim.shape[1])]
    psim = simulate(N=N, trials=stim.shape[1], H=H, connection_prob=0.05,
                    stim_matrix=stim, batch_size=1000, verbose=False)
    data = f"{tmp}/expt1v10.mat"
    savemat(data, {"pscs": np.asarray(psim["psc"], np.float32),
                   "stimulus_matrix": stim.astype(np.float32)})
    args = p1v10.parse_args(["--data", data, "--demixer", str(CHECKPOINT),
                             "--out", f"{tmp}/out1v10"])
    import contextlib
    import io

    import torch

    buf = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        fits, psc_dem, stim_m = p1v10.run(args)
        p1v10.export(args, fits)
    torch.cuda.synchronize()
    secs = time.time() - t0
    paths["cmd_pipeline_1v10"] = launches = kernel_launches(read_counts())
    hold_fit_launches(launches, "pipeline-1v10", fits=2, iters=50)
    out = {}
    w = psim["weights"]
    for name in ("single", "ensemble"):
        model, locs = fits[name]
        want = Model(N).fit(psc_dem[locs], stim_m[:, locs] * 1.0,
                            fit_options=ONE_V_TEN_OPTS)
        d, same = hold_equal(model.state, want.state, f"pipeline-1v10 {name}")
        mu = model.state["mu"]
        seen = np.asarray(psim["spks"])[:, locs].sum(axis=1) >= MIN_SPIKES
        out[name] = dict(trials=int(len(locs)), r2=r2_score(w, mu),
                         r2_revealed=r2_score(w[seen], mu[seen]),
                         hidden_connected=int(np.sum((w != 0) & ~seen)),
                         rel_diff=d, bitwise=same, fit_s=model.time)
        if name == "single":
            t1 = time.time()
            wit = plain64_blocked_fit(psc_dem[locs], stim_m[:, locs] * 1.0,
                                      ONE_V_TEN_OPTS).state["mu"]
            out[name].update(
                witness_s=time.time() - t1,
                witness_r2=r2_score(w, wit),
                witness_r2_revealed=r2_score(w[seen], wit[seen]),
                witness_flips=int(np.sum((wit != 0) != (mu != 0))))
        # the narrowed hold only where the witness cannot pass either
        revealed_only = out[name].get("witness_r2", 1.0) < 0.98
        hold_r2(w[seen] if revealed_only else w, mu[seen] if revealed_only
                else mu, f"pipeline-1v10 {name}"
                + (f" (cells with >= {MIN_SPIKES} spikes)" if revealed_only
                   else ""))
    wit = out["single"]
    log(f"pipeline-1v10 run + export: {secs:.3f} s (demix of {K} traces, "
        f"2 fits); launches {launches}; "
        + "; ".join(f"{n}: {o['trials']} trials, truth-R2 {o['r2']:.6f} "
                    f"({o['r2_revealed']:.6f} over the cells with >= "
                    f"{MIN_SPIKES} spikes; {o['hidden_connected']} connected "
                    f"cells with fewer), fit {o['fit_s']:.3f} s, against "
                    f"Model.fit "
                    f"{o['rel_diff']:.3e} (bit for bit: {o['bitwise']})"
                    for n, o in out.items())
        + f"; single-target witness (plain blocked sweep in float64, "
        f"{wit['witness_s']:.1f} s): truth-R2 {wit['witness_r2']:.6f} "
        f"({wit['witness_r2_revealed']:.6f} over the cells with >= "
        f"{MIN_SPIKES} spikes), {wit['witness_flips']} cells connected in "
        f"one fit and not the other; single-target fit held over "
        + ("the revealed cells" if wit["witness_r2"] < 0.98
           else "all cells")
        + "; " + " | ".join(ln for ln in buf.getvalue().splitlines()
                            if ln.startswith(("trials:", "single-vs",
                                              "Wrote"))))
    rec.update(pipeline_1v10_s=secs, pipeline_1v10=out)
    return secs


def wf_distributed(tmp, dem, sim, rec, paths):
    """distributed-fit: two processes on cuda:0 (gloo), uneven halves of
    the demixed main map, 10 iterations at 8 rows a block, against the
    unsharded caviar_sharded fit of the same trials."""
    import socket

    from circuitmap_torch.parallel import caviar_sharded, trial_mesh

    host = dem.cpu().numpy()
    stim = np.asarray(sim["stim_matrix"], np.float32)
    for rank, (a, b) in enumerate(((0, GLOO_SPLIT), (GLOO_SPLIT, K))):
        np.savez(f"{tmp}/shard{rank}.npz", psc=host[a:b], stim=stim[:, a:b])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # each rank through the command's main, then its kernels' launches
    wrapper = ("import json, sys\n"
               "from circuitmap_torch.__main__ import main\n"
               "from circuitmap_torch.ops import laplace_cuda, sweep_cuda, "
               "sweep_row_cuda\n"
               "rc = main(['distributed-fit', *sys.argv[1:]])\n"
               "print('LAUNCHES', json.dumps({"
               "'sweep_blocked': sweep_cuda.sweep_spikes_blocked.launches, "
               "'laplace': laplace_cuda.laplace_from_stats.launches, "
               "'sweep_row': sweep_row_cuda.sweep_spikes_row.launches}))\n"
               "sys.exit(rc)\n")
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", wrapper, "--coordinator", f"localhost:{port}",
         "--num-processes", "2", "--process-id", str(rank), "--data",
         f"{tmp}/shard{rank}.npz", "--out", f"{tmp}/dist{rank}.npz",
         "--iters", "10", "--sweep-block-size", "8", "--powers",
         *map(str, POWERS)], cwd=tmp, env=cli_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    secs = time.time() - t0
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"distributed-fit rank failed:\n"
                                 f"{text[-3000:]}")
    lines = [json.loads([ln for ln in text.splitlines()
                         if ln.startswith("{")][-1]) for text in logs]
    counts = [json.loads([ln for ln in text.splitlines()
                          if ln.startswith("LAUNCHES")][-1].split(" ", 1)[1])
              for text in logs]
    ranks = [dict(np.load(f"{tmp}/dist{r}.npz")) for r in range(2)]
    if not all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]):
        raise AssertionError("the ranks' gathered outputs differ")
    require_launches(
        [c["laplace"] for c in counts] == [10, 10] and not any(
            c["sweep_blocked"] or c["sweep_row"] for c in counts),
        "distributed-fit", counts, "B2 once an iteration a rank, no sweep "
        "kernel")
    paths["cmd_distributed_fit"] = {
        k: sum(c[k] for c in counts) for k in counts[0]}
    from circuitmap_torch import default_priors

    p = default_priors(N)
    want = caviar_sharded(
        dem, sim["stim_matrix"], p["mu"], p["beta"], p["shape"], p["rate"],
        p["phi"], p["phi_cov"], mesh=trial_mesh(devices=[CARD]), iters=10,
        msrmp=0.3, powers=list(POWERS), sweep_block_size=8, fn_scan=False,
        verbose=False)
    got = ranks[0]
    for f in FIT_FIELDS:
        if np.isnan(got[f]).any():
            raise AssertionError(f"distributed-fit: {f} holds a NaN")
    gate_check(got["mu"], want[0], "distributed-fit (2 gloo ranks on "
               "cuda:0) vs the unsharded caviar_sharded fit")
    d = max_rel_diff(got, fit_dict(want), FIT_FIELDS)
    log(f"distributed-fit, 2 processes on cuda:0 (gloo), {GLOO_SPLIT} / "
        f"{K - GLOO_SPLIT} trials, 10 iterations at block 8: {secs:.3f} s "
        f"for both (process start included); JSON lines {lines}; launches "
        f"per rank {counts}; the ranks' outputs bit for bit equal; largest "
        f"relative difference from the unsharded fit {d:.3e}")
    rec.update(distributed_fit_s=secs, distributed_rel_diff=d,
               distributed_lines=lines)
    return secs


# both fine-tunes run with torch.backends.cudnn.deterministic set, so
# training repeats bit for bit (the U-Net resize's backward is a product)
QAT_RTOL = 0.0


def wf_demixer(tmp, rec, paths):
    """train-qat-demixer (int4d2, 5,000 pairs, 1 epoch) against the same
    fine-tune in process (the pairs drawn with the same seeds, the wire
    rule applied, ``train``), both with cuDNN's deterministic
    algorithms: the epoch's losses and the trained state within QAT_RTOL
    (state-wide, as phase 22). Then export-ckpt of what the command
    wrote, reloaded. Neither launches a fit kernel."""
    import torch
    from circuitmap_torch.demix import convert
    from circuitmap_torch.demix.demixer import NeuralDemixer, wire_transform

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        np.random.seed(0)
        qat = f"{tmp}/qat.npz"
        out, secs, launches = cli_command(
            "train-qat-demixer", ["--decimate", 2, "--size", 5000,
                                  "--epochs", 1, "--pretrained", TRAIN_BASE,
                                  "--out", qat])
        paths["cmd_train_qat_demixer"] = launches
        meta = json.loads(out.strip().splitlines()[-1])
        if meta["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"train-qat-demixer record {meta}")
        np.random.seed(0)
        dm = NeuralDemixer(str(TRAIN_BASE), seed=0)
        dm.generate_training_data(**dict(QAT_DATA, size=5000))
        dm.training_data, dm.test_data = (
            (wire_transform(x, bits=4, decimate=2), y)
            for x, y in (dm.training_data, dm.test_data))
        (hist,) = dm.train(epochs=1, learning_rate=2e-3, seed=0,
                           verbose=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    loss_d = max(abs(meta[f"final_{k}"] - hist[k]) / abs(hist[k])
                 for k in ("train_loss", "val_loss"))
    state_d = state_rel_diff(convert.load_params(qat), dm.net.state_dict())
    if not loss_d <= QAT_RTOL or not state_d <= QAT_RTOL:
        raise AssertionError(
            f"train-qat-demixer {meta} against the in-process fine-tune "
            f"{hist}: losses {loss_d:.3e}, state {state_d:.3e} apart "
            f"(> {QAT_RTOL})")
    eout, esecs, elaunch = cli_command(
        "export-ckpt", [qat, f"{tmp}/qat.ckpt", "--epoch", 1])
    paths["cmd_export_ckpt"] = elaunch
    for what, counts in (("train-qat-demixer", launches),
                         ("export-ckpt", elaunch)):
        require_launches(not any(fit_kernel_launches(counts).values()),
                         what, counts, "no fit kernel")
    back, trained = (convert.load_params(p) for p in (f"{tmp}/qat.ckpt", qat))
    if not all(torch.equal(back[k], v) for k, v in trained.items()):
        raise AssertionError("the exported checkpoint does not reload bit "
                             "for bit")
    NeuralDemixer(f"{tmp}/qat.ckpt")  # the .ckpt loads as a demixer
    log(f"train-qat-demixer --decimate 2 --size 5000 --epochs 1: {secs:.3f} s"
        f" (host data generation included); record {meta}; against the "
        f"in-process fine-tune: losses {loss_d:.3e}, state {state_d:.3e} "
        f"relative; export-ckpt {esecs:.3f} s: {eout.strip()}; reloaded bit "
        f"for bit")
    rec.update(train_qat_s=secs, train_qat=meta, export_ckpt_s=esecs,
               train_qat_loss_rel_diff=loss_d,
               train_qat_state_rel_diff=state_d)
    return secs + esecs


def wf_grids(tmp, rec, paths):
    """denoise-grids on a single-spot grid of 1,000 locations (2 planes
    of 25 x 20), each location 20 times over the 3 powers."""
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.scripts.denoise_grids import (
        make_plane_stim_matrices, weight_map_image)

    nx, ny = GRID_SIDE
    xs, ys = np.meshgrid(np.arange(nx) * 10.0, np.arange(ny) * 10.0,
                         indexing="ij")
    locs = np.array([(x, y, z) for z in (0.0, 30.0)
                     for x, y in zip(xs.ravel(), ys.ravel())])
    n = len(locs)
    rng = np.random.default_rng(5)
    target = np.tile(np.arange(n), K // n)
    power = np.asarray(POWERS)[rng.integers(0, 3, target.size)]
    stim = np.zeros((n, target.size), np.float32)
    stim[target, np.arange(target.size)] = power
    np.random.seed(3)
    gsim = simulate(N=n, trials=target.size, H=1, connection_prob=0.05,
                    stim_matrix=stim, batch_size=1000, verbose=False)
    data = f"{tmp}/grid.npz"
    np.savez(data, psc=np.asarray(gsim["psc"], np.float32), I=power,
             L=locs[target])
    out, secs, launches = cli_command(
        "denoise-grids", ["--data", data, "--demixer", CHECKPOINT, "--out",
                          f"{tmp}/grids"])
    paths["cmd_denoise_grids"] = launches
    hold_fit_launches(launches, "denoise-grids", fits=2, iters=30)
    maps = np.load(f"{tmp}/grids/weight_maps.npz")
    dem = NeuralDemixer(str(CHECKPOINT))(
        np.asarray(gsim["psc"], np.float32).astype(float), verbose=False)
    worst, r2s = 0.0, []
    for z, pstim, trials, plane_locs in make_plane_stim_matrices(
            power, locs[target]):
        model = Model(pstim.shape[0]).fit(
            dem[trials], pstim, fit_options={"iters": 30, "msrmp": 0.2,
                                             "save_histories": False,
                                             "verbose": False})
        want = weight_map_image(plane_locs, model.state["mu"])
        d, _ = hold_equal({"mu": maps[f"plane_{z:g}"]}, {"mu": want},
                          f"denoise-grids plane {z:g}", fields=("mu",))
        worst = max(worst, d)
        on_plane = locs[:, 2] == z
        r2s.append(hold_r2(gsim["weights"][on_plane],
                           model.state["mu"], f"plane {z:g}", floor=None))
    log(f"denoise-grids ({n} locations, {target.size} single-spot trials, "
        f"2 planes, 30 iterations): {secs:.3f} s; launches {launches}; "
        f"maps against Model.fit {worst:.3e}; truth-R2 per plane "
        f"{[round(r, 6) for r in r2s]}; "
        + " | ".join(ln for ln in out.splitlines() if ln.startswith("plane")))
    rec.update(denoise_grids_s=secs, denoise_grids_r2=r2s,
               denoise_grids_rel_diff=worst)
    return secs


def wf_studies(tmp, sim, dem, model, rec, paths):
    """simulations (defaults), downsampling (fractions 0.25 and 1.0 of
    the demixed main map), signal-fidelity (defaults) and design-study
    (1 seed)."""
    import bz2
    import pickle

    import torch
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.utils.metrics import r2_score

    total = 0.0
    # simulations
    out, secs, launches = cli_command("simulations", ["--out", tmp])
    total += secs
    paths["cmd_simulations"] = launches
    hold_fit_launches(launches, "simulations", fits=1, iters=50, sns_fits=1)
    with bz2.BZ2File(f"{tmp}/simulation_results_sim_N300_K2000.pkl.bz2") as fh:
        res = pickle.load(fh)
    np.random.seed(0)
    ssim = simulate(N=300, trials=2000, H=10, connection_prob=0.05,
                    spont_prob=0.05, verbose=False)
    diffs = {}
    for method, opts in (("caviar", {"msrmp": 0.3}), ("cavi_sns", {})):
        want = Model(300).fit(ssim["psc"], ssim["stim_matrix"], method=method,
                              fit_options=dict(opts, iters=50,
                                               verbose=False))
        diffs[method] = hold_equal(res[method]["state"], want.state,
                                   f"simulations {method}")
    log(f"simulations (N=300, 2000 trials, 50 iterations): {secs:.3f} s; "
        f"launches {launches}; truth-R2 caviar {res['caviar']['r2']:.6f}, "
        f"cavi_sns {res['cavi_sns']['r2']:.6f}, cosamp "
        f"{res['cosamp']['r2']:.6f}; against Model.fit (relative, bit for "
        f"bit) {diffs}")
    rec.update(simulations_s=secs, simulations_r2={
        m: res[m]["r2"] for m in ("caviar", "cavi_sns", "cosamp")})

    # downsampling on phase 5's demixed traces
    data = f"{tmp}/main.npz"
    save_expt(data, dem.cpu().numpy(), sim["stim_matrix"])
    out, secs, launches = cli_command(
        "downsampling", ["--data", data, "--fractions", 0.25, 1.0,
                         "--repeats", 1, "--out", f"{tmp}/ds.npz"])
    total += secs
    paths["cmd_downsampling"] = launches
    hold_fit_launches(launches, "downsampling", fits=2, iters=50)
    ds = np.load(f"{tmp}/ds.npz")
    d_main, same = hold_equal({"mu": ds["weights"][1, 0]}, model.state,
                              "downsampling at 1.0 vs phase 5", ("mu",))
    r2 = hold_r2(sim["weights"], ds["weights"][1, 0], "downsampling 1.0")
    host = dem.cpu().numpy().astype(float)
    sel = np.sort(np.random.default_rng(0).choice(K, K // 4, replace=False))
    quarter = Model(N).fit(host[sel], sim["stim_matrix"][:, sel],
                           fit_options={"iters": 50, "msrmp": 0.3,
                                        "verbose": False})
    d_q, _ = hold_equal({"mu": ds["weights"][0, 0]}, quarter.state,
                        "downsampling at 0.25", ("mu",))
    log(f"downsampling --fractions 0.25 1.0 --repeats 1: {secs:.3f} s; "
        f"launches {launches}; at 1.0 against phase 5's fit {d_main:.3e} "
        f"(bit for bit: {same}), truth-R2 {r2:.6f}; at 0.25 against "
        f"Model.fit {d_q:.3e}, truth-R2 "
        f"{r2_score(sim['weights'], ds['weights'][0, 0]):.6f}")
    rec.update(downsampling_s=secs, downsampling_r2=r2,
               downsampling_rel_diff_vs_main=d_main)

    # signal-fidelity
    out, secs, launches = cli_command(
        "signal-fidelity", ["--demixer", CHECKPOINT, "--out",
                            f"{tmp}/sf.npz"])
    total += secs
    paths["cmd_signal_fidelity"] = launches
    require_launches(
        not any(fit_kernel_launches(launches).values())
        and launches["relu_resize_cat"] > 0, "signal-fidelity", launches,
        "no fit kernel; the demixer's epilogue kernel")
    sf = dict(np.load(f"{tmp}/sf.npz"))
    if any(np.isnan(v).any() for v in sf.values()):
        raise AssertionError("signal-fidelity output holds a NaN")
    demixer = NeuralDemixer(str(CHECKPOINT))
    d_sf = max(max_rel_diff({"x": demixer(sf[f"obs_{f}"], verbose=False)},
                            {"x": sf[f"demixed_{f}"]}, ("x",))
               for f in (10, 30, 50))
    if d_sf > WF_RTOL:
        raise AssertionError(f"signal-fidelity demix differs by {d_sf:.3e}")
    log(f"signal-fidelity (N=100, 60 s, 10/30/50 Hz): {secs:.3f} s; "
        f"launches {launches}; demixed against the in-process demixer "
        f"{d_sf:.3e}; " + " | ".join(ln for ln in out.splitlines()
                                     if ln.startswith("stim_freq")))
    rec.update(signal_fidelity_s=secs)

    # design-study
    out, secs, launches = cli_command(
        "design-study", ["--seeds", 1, "--out", f"{tmp}/design.json"])
    total += secs
    paths["cmd_design_study"] = launches
    study = json.load(open(f"{tmp}/design.json"))
    seed0 = study["per_seed"][0]
    reset_counts()
    arms = replay_design_study()
    replay_launches = kernel_launches(read_counts())
    rounds = seed0["static_rounds"] + seed0["adaptive_rounds"]
    require_launches(
        launches == replay_launches and launches["sweep_blocked"] ==
        8 * rounds and not launches["sweep_row"], "design-study", launches,
        f"the replay's {replay_launches}, B1 8 an update over {rounds} "
        f"rounds")
    stop = arms["adaptive"][-1]["trials"]
    matched = max((h for h in arms["static"] if h["trials"] <= stop),
                  key=lambda h: h["trials"])
    worst = 0.0
    for arm, want in (("adaptive_final", arms["adaptive"][-1]),
                      ("static_full_budget", arms["static"][-1]),
                      ("static_at_matched_budget", matched)):
        got = seed0[arm]
        worst = max(worst, abs(got["r2"] - want["r2"]) / abs(want["r2"]))
        if sorted(got) != sorted(want) or any(
                got[k] != want[k] for k in want if k != "r2") or not \
                np.isfinite(got["r2"]) or worst > WF_RTOL:
            raise AssertionError(f"design-study {arm} {got} against the "
                                 f"library's replay {want}")
    if (seed0["static_rounds"], seed0["adaptive_rounds"]) != (
            len(arms["static"]), len(arms["adaptive"])):
        raise AssertionError(f"design-study rounds {seed0} against the "
                             f"replay's {len(arms['static'])}, "
                             f"{len(arms['adaptive'])}")
    torch.cuda.synchronize()
    log(f"design-study --seeds 1: {secs:.3f} s; launches {launches} (the "
        f"library's replay: {replay_launches}); "
        + out.strip().splitlines()[-1]
        + f"; both arms equal the replay's (R2 within {worst:.3e})")
    rec.update(design_study_s=secs, design_study=seed0)
    return total


def replay_design_study(N=120, H=5, block=360, rounds=10,
                        connection_prob=0.08, powers=(45.0, 55.0, 65.0)):
    """Seed 0 of design-study at its defaults rebuilt from the library
    (``simulate``, ``blockwise_design``, ``OnlineCaviar``,
    ``AdaptiveDesigner``, the metrics), drawing from ``np.random`` in the
    command's order: the circuit, the designs, the static arm, then the
    adaptive arm. Returns each arm's per-round records."""
    from circuitmap_torch import OnlineCaviar, simulate
    from circuitmap_torch.design import AdaptiveDesigner
    from circuitmap_torch.simulation import blockwise_design
    from circuitmap_torch.utils.metrics import (precision_recall_connections,
                                                r2_score)

    powers = list(powers)
    np.random.seed(100)
    truth = simulate(N=N, trials=8, H=H, powers=powers,
                     connection_prob=connection_prob, verbose=False)
    designs = [blockwise_design(N, H, block, powers) for _ in range(rounds)]
    arms = {}
    for adaptive in (False, True):
        oc = OnlineCaviar(N, powers=powers)
        designer = AdaptiveDesigner(N, H, powers, null_trials=18,
                                    conn_trials=30)
        history = []
        for r, stim in enumerate(designs):
            if adaptive and r > 0:
                stim = designer.next_design(stim.shape[1])
            psc = simulate(N=N, stim_matrix=stim, weights=truth["weights"],
                           phi_0=truth["phi_0"], phi_1=truth["phi_1"],
                           kernel=(truth["tau_r"], truth["tau_d"]),
                           powers=powers, verbose=False)["psc"]
            oc.update(psc, stim, iters=8)
            post = oc.posterior()
            designer.observe(stim, post)
            prec, rec = precision_recall_connections(truth["weights"],
                                                     post["mu"])
            history.append({"trials": int(oc.trial_count),
                            "r2": float(r2_score(truth["weights"],
                                                 post["mu"])),
                            "precision": float(prec), "recall": float(rec),
                            "unresolved": int(designer.pool.size)})
            if adaptive and designer.resolved:
                break
        arms["adaptive" if adaptive else "static"] = history
    return arms


def phase_workflows(sim, dem, model):
    """Phase 28: the workflow commands of ``python -m circuitmap_torch``
    on the card, at the main map's width (N=1000, K=20000, powers 45 /
    55 / 65; the commands' demixer is the int4d2 QAT checkpoint on their
    default f32 wire), each driven in process through ``main(argv)`` and
    held against its in-process counterpart (1e-6 relative; the
    posterior where the command writes one), with its B1/B2/B3 launches
    counted from 0:

    ``loho-cv`` (2 of 10,000 folds of an experiment whose holograms
    repeat twice), ``fanout-jobs`` (bash; the emitted script cut to the
    same 2 folds and run, each fold a ``python -m circuitmap_torch
    loho-cv --fold I`` worker in a subprocess: its fold files equal the
    sweep's records), ``pipeline-1v10``'s run and export steps (10,000
    single-target and 10,000 10-target trials; truth-R2 >= 0.98 for the
    ensemble fit, and for the single-target fit over all cells or, where
    its float64 plain-sweep witness also falls below 0.98, over the
    cells its trials reveal), ``distributed-fit`` (two processes on
    cuda:0 under gloo, 10 iterations, against the unsharded
    ``caviar_sharded``), ``train-qat-demixer`` (int4d2, 5,000 pairs, 1
    epoch; losses and state within 1e-4 of the same fine-tune in
    process) and ``export-ckpt`` (reloaded bit for bit), ``denoise-grids``
    (1,000 locations), ``simulations`` (defaults), ``downsampling``
    (0.25 and 1.0 of the demixed main map: 1.0 equals phase 5's fit),
    ``signal-fidelity`` (defaults) and ``design-study`` (1 seed; both
    arms and the launches equal the library's replay of the protocol).
    The commands that fit nothing (``fanout-jobs``,
    ``train-qat-demixer``, ``export-ckpt``, ``signal-fidelity``) must
    launch no fit kernel.

    Not here: ``continuous`` (it reads YAML) and ``pipeline-1v10``'s
    figure (matplotlib): neither package is known to be on the card's
    machine, so the CPU tests hold them (tests/test_torch_cli_*.py), as
    ``pipeline-pair-patch`` and ``train-demixer``, whose paths these
    commands share."""
    import tempfile

    log("phase 28: the workflow commands of python -m circuitmap_torch "
        "(N=1000, K=20000, the int4d2 QAT checkpoint)")
    paths, rec = {}, {}
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        steps = [("loho-cv + fanout-jobs", lambda: wf_loho(tmp, rec, paths)),
                 ("pipeline-1v10", lambda: wf_1v10(tmp, rec, paths)),
                 ("distributed-fit",
                  lambda: wf_distributed(tmp, dem, sim, rec, paths)),
                 ("train-qat-demixer + export-ckpt",
                  lambda: wf_demixer(tmp, rec, paths)),
                 ("denoise-grids", lambda: wf_grids(tmp, rec, paths)),
                 ("studies", lambda: wf_studies(tmp, sim, dem, model, rec,
                                                paths))]
        for name, step in steps:
            t1 = time.time()
            step()
            rec[f"step_s_{name}"] = time.time() - t1
    rec["phase_s"] = time.time() - t0
    log(f"phase 28 took {rec['phase_s']:.1f} s; launches by command "
        f"{paths}")
    return paths, rec


F64_RTOL = 1e-10      # a float64 kernel against its float64 plain version
F64_FIT_RTOL = 1e-8   # phase 29's float64 fit against its plain-sweep witness
F64_SNS_ITERS = 3     # phase 29's float64 CAVI-SnS fit
OFF_CHIP_F64 = (200, 60000)  # past the float64 sweep's on-chip K (41,344)


def hold_f64(ker, plain, what):
    """A float64 kernel's output against its float64 plain version's on
    the same inputs: within F64_RTOL of the largest entry, and with the
    gate on not one gate decision apart (a row all zero in one and not
    in the other). Returns the largest difference."""
    import torch

    if ker.dtype != torch.float64:
        raise AssertionError(f"{what}: the kernel returned {ker.dtype}")
    err = (ker - plain).abs().max().item()
    scale = plain.abs().max().item()
    flips = int(((ker.sum(-1) == 0) != (plain.sum(-1) == 0)).sum())
    log(f"{what}: max |kernel - plain| = {err:.3e} ({err / scale:.3e} of "
        f"the largest entry); {flips} gate decisions differ")
    if err > F64_RTOL * scale or flips:
        raise AssertionError(f"{what}: the float64 kernel is not within "
                             f"{F64_RTOL} of its plain version with 0 gate "
                             "flips")
    return err


def laplace_ulp_spread(S, C, levels, pp, pc):
    """How far the float64 plain Laplace refit moves when S moves by one
    ulp (each entry up or down at random): (phi's largest difference
    over its largest entry, the largest per-lane covariance difference
    over that lane's largest entry). The recursion is ill-conditioned
    at closely spaced levels and its Armijo ties fall either way, so no
    float64 implementation that sums in another order sits closer."""
    import torch
    from circuitmap_torch.ops import laplace_cuda as lc

    g = torch.Generator(device=S.device).manual_seed(0)
    sign = torch.randint(0, 2, S.shape, generator=g, device=S.device).to(
        S.dtype) * 2 - 1
    nudged = S * (1 + sign * torch.finfo(S.dtype).eps)
    return laplace_rel(lc.laplace_from_stats_torch(nudged, C, levels, pp, pc),
                       lc.laplace_from_stats_torch(S, C, levels, pp, pc))


def laplace_rel(got, want):
    (phi, cov), (phi0, cov0) = got, want
    per = (cov - cov0).abs().flatten(-2).amax(-1) \
        / cov0.abs().flatten(-2).amax(-1)
    return ((phi - phi0).abs().max() / phi0.abs().max()).item(), \
        per.max().item()


def check_laplace64(S, C, levels, what):
    """The Laplace kernel with float64 I/O against its float64 plain
    version: within F64_RTOL, or, where the recursion's own conditioning
    does not allow that (laplace_ulp_spread), within 10 times that
    spread; then its device time (a CUDA graph of 20 launches), the
    plain version's and the bound at 8 bytes an element."""
    import torch
    from circuitmap_torch import default_priors
    from circuitmap_torch.ops import laplace_cuda as lc

    lanes, P1 = S.shape[:-1], S.shape[-1]
    L = lanes.numel()
    p = default_priors(L)
    pp = torch.from_numpy(p["phi"]).double().cuda()
    pc = torch.from_numpy(p["phi_cov"]).double().cuda()
    got = lc.laplace_from_stats(S, C, levels, pp, pc)
    want = lc.laplace_from_stats_torch(S, C, levels, pp, pc)
    errs, spread = laplace_rel(got, want), laplace_ulp_spread(S, C, levels,
                                                              pp, pc)
    tol = [max(F64_RTOL, 10 * sp) for sp in spread]
    log(f"{what}: float64 kernel vs float64 plain: phi {errs[0]:.3e}, cov "
        f"{errs[1]:.3e} (relative); the plain version's own one-ulp spread "
        f"phi {spread[0]:.3e}, cov {spread[1]:.3e}; held to "
        f"{tol[0]:.3e} / {tol[1]:.3e}; within {F64_RTOL}: "
        f"{max(errs) <= F64_RTOL}")
    if errs[0] > tol[0] or errs[1] > tol[1]:
        raise AssertionError(f"{what}: the float64 Laplace kernel is off "
                             "its plain version beyond the recursion's "
                             "conditioning")
    args, _, _ = lc._prepare(S, C, levels, pp, pc)
    ms = graph_ms(lambda: lc._enqueue(args))
    plain_ms = cuda_ms(lambda: lc.laplace_from_stats_torch(S, C, levels, pp,
                                                           pc),
                       reps=5, warmup=1)
    candidates, _ = laplace_trips(S, C, levels, pp, pc, what)
    nbytes = 8 * (2 * L * P1 + P1 + 2 * L + 4 * L + 2 * L + 4 * L)
    ops = OPS_PER_BUCKET * P1 * (L * lc.NEWTON_STEPS + L + candidates)
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F64_FLOPS) * 1e3
    bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S > ops / PEAK_F64_FLOPS
                else "operations")
    log(f"{what}: float64 Laplace kernel {ms:.5f} ms device (CUDA graph), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1]).abs().max().item())
    return dict(max_abs_err=err, rel_err=errs, ulp_spread=spread, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms)


def phase_float64(sim, dem):
    """Phase 29: float64 on the card (ROADMAP C1). B1 at 8 rows, B3 at
    one row, B5 (E=4) and B2 in float64 at the main shape against their
    float64 plain versions (hold_f64, check_laplace64), with each
    kernel's ms; B1 in double off chip (N=200, K=60,000: past the
    float64 form's on-chip K); ``Model.fit(dtype=float64)`` on the main
    map (50 float64 B1 and 51 float64 B2 launches, truth-R2 >= 0.98,
    mu within F64_FIT_RTOL of the same fit with ``caviar._SWEEPS``
    swapped for the float64 plain blocked sweep); a float64 CAVI-SnS fit
    of F64_SNS_ITERS iterations (float64 B3 once an iteration). Returns
    (launches by path, the three float64 kernel records)."""
    import importlib

    import torch
    from circuitmap_torch import Model
    from circuitmap_torch.ops import sweep_cuda as sc
    from circuitmap_torch.ops import sweep_row_cuda as sr
    from circuitmap_torch.solvers._laplace import powercurve_stats
    from circuitmap_torch.utils.metrics import r2_score

    log("phase 29: float64 on the card (B1, B3, B5, B2 against their "
        "float64 plain versions; a float64 main-map fit; float64 CAVI-SnS)")
    f64 = torch.float64
    t0 = time.time()
    a = {k: (v.double() if v.is_floating_point() else v)
         for k, v in sweep_inputs().items()}
    bound_b = 3 * N * K * 8 / PEAK_BYTES_PER_S * 1e3
    errs = []
    for gate in (0, 1):
        errs.append(hold_f64(sweep_call(sc.sweep_spikes_blocked, a, gate),
                             sweep_call(sc.sweep_spikes_blocked_torch, a,
                                        gate),
                             f"B1 float64, 8 rows, gate {gate}"))
    b1_ms = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked, a, 1))
    b1_plain = cuda_ms(lambda: sweep_call(sc.sweep_spikes_blocked_torch, a,
                                          1), reps=3, warmup=1)
    lam64 = sweep_call(sc.sweep_spikes_blocked, a, 1)
    log(f"B1 float64 {b1_ms:.4f} ms, plain {b1_plain:.3f} ms, byte bound "
        f"{bound_b:.4f} ms (3*N*K*8 B), {bound_b / b1_ms:.1%}")
    b1 = dict(name="sweep_blocked_f64", route="cuda",
              source="circuitmap_torch/csrc/sweep_cluster.cuh",
              replaces="circuitmap_tpu/ops/sweep_pallas.py:658",
              max_abs_err=max(errs), ms=b1_ms, plain_ms=b1_plain,
              bound_ms=bound_b, bound_by="bytes", library_ms=None,
              bound_share=bound_b / b1_ms, rows_per_step=8,
              plan=sc.launch_plan(1, K, 8, len(POWERS), 8)._asdict())

    n, k = OFF_CHIP_F64
    wide = {key: (v.double() if v.is_floating_point() else v)
            for key, v in sweep_inputs(seed=2, n=n, k=k).items()}
    plan = sc.launch_plan(1, k, 8, len(POWERS), 8)
    if plan.on_chip:
        raise AssertionError(f"K={k} in float64 must keep r off chip: {plan}")
    b1["off_chip_max_abs_err"] = hold_f64(
        sweep_call(sc.sweep_spikes_blocked, wide, 1),
        sweep_call(sc.sweep_spikes_blocked_torch, wide, 1),
        f"B1 float64 off chip, N={n} K={k} ({plan})")
    del wide

    errs = [hold_f64(row_call(sr.sweep_spikes_row, a, g),
                     row_call(sr.sweep_spikes_row_torch, a, g),
                     f"B3 float64, one row, gate {g}") for g in (0, 1)]
    b3_ms = cuda_ms(lambda: row_call(sr.sweep_spikes_row, a, 1))
    b3_plain = cuda_ms(lambda: row_call(sr.sweep_spikes_row_torch, a, 1),
                       reps=2, warmup=1)
    E, KE = 4, 15000
    b = stack_inputs([sweep_inputs(seed=10 + e, k=KE) for e in range(E)])
    b = {key: (v.double() if v.is_floating_point() else v)
         for key, v in b.items()}
    kw = dict(msrmp=per_expt(0.3, 0.35, 0.4, 0.45).double(),
              sig=per_expt(0.1, 0.12, 0.09, 0.11).double())
    err_b5 = max(hold_f64(row_call(sr.sweep_spikes_row_batched, b, g, **kw),
                          row_call(sr.sweep_spikes_row_batched_torch, b, g,
                                   **kw),
                          f"B5 float64, E={E} K={KE}, gate {g}")
                 for g in (0, 1))
    b5_ms = cuda_ms(lambda: row_call(sr.sweep_spikes_row_batched, b, 1, **kw))
    del b
    log(f"B3 float64 {b3_ms:.4f} ms (plain {b3_plain:.3f} ms); B5 float64 "
        f"E={E} {b5_ms:.4f} ms")
    b3 = dict(name="sweep_row_f64", route="cuda",
              source="circuitmap_torch/csrc/sweep_cluster.cuh",
              replaces="circuitmap_tpu/ops/sweep_pallas.py:338, :89, :481",
              max_abs_err=max(errs), ms=b3_ms, plain_ms=b3_plain,
              bound_ms=bound_b, bound_by="bytes", library_ms=None,
              bound_share=bound_b / b3_ms, rows_per_step=1,
              batched=dict(E=E, K=KE, max_abs_err=err_b5, ms=b5_ms,
                           bound_ms=3 * E * N * KE * 8 / PEAK_BYTES_PER_S
                           * 1e3))

    S, C, levels = powercurve_stats(lam64, a["stim"], a["powers"],
                                    total_trials=K, counts=a["power_counts"])
    b2 = dict(name="laplace_f64", route="cuda",
              source="circuitmap_torch/csrc/laplace.cu",
              replaces="circuitmap_tpu/ops/laplace_pallas.py:149",
              library_ms=None, **check_laplace64(S, C, levels,
                                                 "B2 float64, N=1000"))
    del a, lam64
    torch.cuda.empty_cache()

    opts = {"iters": 50, "msrmp": 0.3, "powers": list(POWERS),
            "verbose": False, "dtype": f64}
    paths = {}
    reset_counts()
    model, fit_s = timed(lambda: Model(N).fit(dem, sim["stim_matrix"],
                                              method="caviar",
                                              fit_options=dict(opts)))
    paths["f64_main_fit"] = launches = kernel_launches(read_counts())
    mu = np.asarray(model.state["mu"])
    r2 = r2_score(sim["weights"], mu)
    log(f"Model.fit(dtype=float64) on the main map: {fit_s:.3f} s, "
        f"launches {launches}, truth-R2 {r2:.6f}, mu {mu.dtype}")
    require_launches(launches == launch_dict(0, 0, 0, (50, 51, 0)),
                     "the float64 main-map fit", launches,
                     "50 float64 B1, 51 float64 B2, no float32 launch")
    if r2 < 0.98 or mu.dtype != np.float64:
        raise AssertionError(f"the float64 fit: truth-R2 {r2:.4f}, mu "
                             f"{mu.dtype}")
    cav = importlib.import_module("circuitmap_torch.solvers.caviar")
    key = (False, False)  # the single fit's blocked sweep
    kernel_sweep, cav._SWEEPS[key] = (cav._SWEEPS[key],
                                      sc.sweep_spikes_blocked_torch)
    reset_counts()
    try:
        witness, witness_s = timed(lambda: Model(N).fit(
            dem, sim["stim_matrix"], method="caviar",
            fit_options=dict(opts)))
    finally:
        cav._SWEEPS[key] = kernel_sweep
    w_launches = kernel_launches(read_counts())
    require_launches(not w_launches["sweep_blocked_f64"],
                     "the float64 plain-sweep witness", w_launches, "no B1")
    mu_w = np.asarray(witness.state["mu"])
    fit_err = float(np.abs(mu - mu_w).max() / np.abs(mu_w).max())
    flips = int(((mu == 0) != (mu_w == 0)).sum())
    log(f"the same fit with the float64 plain blocked sweep ({witness_s:.2f} "
        f"s): mu {fit_err:.3e} of its largest entry apart, {flips} cells "
        f"connected differently")
    if fit_err > F64_FIT_RTOL or flips:
        raise AssertionError(f"the float64 fit is {fit_err:.3e} from its "
                             "plain-sweep witness (or a gate flipped)")

    reset_counts()
    sns, sns_s = timed(lambda: Model(N).fit(
        dem, sim["stim_matrix"], method="cavi_sns",
        fit_options={"iters": F64_SNS_ITERS, "verbose": False, "dtype": f64}))
    paths["f64_sns"] = launches = kernel_launches(read_counts())
    log(f"float64 CAVI-SnS, {F64_SNS_ITERS} iterations: {sns_s:.3f} s, "
        f"launches {launches}")
    require_launches(
        launches == launch_dict(0, 0, 0, (0, F64_SNS_ITERS, F64_SNS_ITERS)),
        "the float64 CAVI-SnS fit", launches,
        f"{F64_SNS_ITERS} float64 B3 and B2")
    if not np.isfinite(np.asarray(sns.state["mu"])).all():
        raise AssertionError("the float64 CAVI-SnS fit is not finite")
    log(f"phase 29 took {time.time() - t0:.1f} s")
    return paths, [b1, b2, b3], dict(fit_s=fit_s, truth_r2=r2,
                                     witness_rel=fit_err, sns_s=sns_s)


def cli_capture(argv):
    """``python -m circuitmap_torch <argv>`` in this process: (its exit
    code, what it printed, its seconds)."""
    import contextlib
    import io

    import torch
    from circuitmap_torch.__main__ import main as cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli(list(map(str, argv)))
    torch.cuda.synchronize()
    return rc or 0, buf.getvalue(), time.time() - t0


def cli_subprocess(argv, limit_s):
    """The same command in a process of its own, from the repository
    root: (exit code, stdout, seconds)."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "circuitmap_torch",
                           *map(str, argv)], cwd=HERE, capture_output=True,
                          text=True, timeout=limit_s)
    if proc.returncode:
        print(proc.stderr[-3000:], file=sys.stderr)
    return proc.returncode, proc.stdout, time.time() - t0


def json_line(out):
    """The last line of ``out`` that parses as a JSON object (or the
    object that starts at the first '{' of an indented dump)."""
    for line in reversed(out.splitlines()):
        if line.startswith("{") and line.endswith("}"):
            return json.loads(line)
    return json.loads(out[out.index("{"):])


def phase_commands():
    """Phase 30: the Operations and Measurement commands of ``python -m
    circuitmap_torch``. ``doctor`` and ``hw-smoke`` (all five probes) in
    processes of their own must exit 0, each check or probe line
    printed; ``warm-cache`` (the main map's shape, on the existing build
    directory) in a process of its own; in this process ``profile-fit``
    (the main map), ``profile-demixer`` (K=20,000, the int4d2 split of
    the demix phase), ``profile-online`` (defaults) and ``scaling-study
    --quick``; ``wire-study`` at one seed; ``memory-cliff --quick`` (one
    subprocess); ``compile-study --warm-only``. Every output goes to a
    temporary directory. Returns (launches by in-process command, the
    commands' records)."""
    import tempfile

    log("phase 30: the Operations and Measurement commands")
    rec, paths = {}, {}
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        def sub(name, argv, limit_s, lines):
            rc, out, secs = cli_subprocess(argv, limit_s)
            shown = [ln for ln in out.splitlines() if ln.startswith(lines)]
            for ln in shown:
                log(f"  {name}: {ln}")
            log(f"{name}: exit {rc} in {secs:.1f} s")
            if rc != 0:
                raise AssertionError(f"{name} exited {rc}")
            rec[name] = dict(s=secs, lines=shown)
            return out

        sub("doctor", ["doctor", "--json", f"{tmp}/doctor.json"], 300,
            ("PASS", "WARN", "FAIL", "SKIP", "doctor:"))
        checks = json.loads(Path(f"{tmp}/doctor.json").read_text())
        if checks["accelerator"]["status"] != "PASS" or \
                checks["native-lib"]["status"] != "PASS":
            raise AssertionError(f"doctor: {checks}")
        sub("hw-smoke", ["hw-smoke", "--json", f"{tmp}/smoke.json"], 900,
            ("[",))
        smoke = json.loads(Path(f"{tmp}/smoke.json").read_text())
        if [p["status"] for p in smoke["probes"]] != ["PASS"] * 5:
            raise AssertionError(f"hw-smoke: {smoke}")
        sub("warm-cache", ["warm-cache", "--shape", f"{N}x{K}", "--demixer",
                           str(CHECKPOINT), "--transfer-dtype", "int4d2"],
            300, ("warm", "kernel library"))

        def inproc(name, argv):
            reset_counts()
            rc, out, secs = cli_capture(argv)
            paths[name] = kernel_launches(read_counts())
            log(f"{name}: exit {rc} in {secs:.1f} s; launches {paths[name]}")
            if rc != 0:
                raise AssertionError(f"{name} exited {rc}")
            rec[name] = dict(s=secs)
            return out

        out = inproc("profile-fit", ["profile-fit"])
        rec["profile-fit"].update(json_line(out))
        log(f"profile-fit: {json_line(out)}")
        out = inproc("profile-demixer", ["profile-demixer", K])
        demix = json_line(out)
        top = dict(list(demix["top_ops_ms"].items())[:5])
        demix["top_ops_ms"] = top
        rec["profile-demixer"].update(demix)
        log(f"profile-demixer (K={K}, int4d2): host encode "
            f"{demix['host_encode_ms']:.3f} ms, upload "
            f"{demix['upload_ms']:.3f} ms, device decode "
            f"{demix['device_decode_ms']:.3f} ms, forward "
            f"{demix['forward_wall_ms_best']:.3f} ms (device "
            f"{demix['device_total_ms']:.3f} ms), the public call "
            f"{demix['demix_call_ms_best']:.3f} ms; top kernels {top}")
        out = inproc("profile-online", ["profile-online"])
        rec["profile-online"].update(json_line(out))
        log(f"profile-online: {json_line(out)}")
        out = inproc("scaling-study", ["scaling-study", "--quick", "--out",
                                       f"{tmp}/scaling.json"])
        rec["scaling-study"]["rows"] = json.loads(
            Path(f"{tmp}/scaling.json").read_text())["results"]
        log(f"scaling-study --quick: {rec['scaling-study']['rows']}")
        out = inproc("wire-study", ["wire-study", "--seeds", 0, "--out",
                                    f"{tmp}/wire.json"])
        rec["wire-study"]["rows"] = json.loads(
            Path(f"{tmp}/wire.json").read_text())["rows"]
        log(f"wire-study, seed 0: {rec['wire-study']['rows']}")
        for name, row in (("scaling-study", rec["scaling-study"]["rows"]),
                          ("wire-study", rec["wire-study"]["rows"])):
            if any(not np.isfinite(r.get("r2", r.get("truth_r2")))
                   for r in row):
                raise AssertionError(f"{name}: a non-finite truth-R2")
        sub("memory-cliff --quick", ["memory-cliff", "--quick", "--out",
                                     f"{tmp}/cliff.json"], 600,
            ("probe", "{", "wrote"))
        cliff = json.loads(Path(f"{tmp}/cliff.json").read_text())
        if not cliff["results"][0]["ok"]:
            raise AssertionError(f"memory-cliff --quick: {cliff}")
        sub("compile-study --warm-only", ["compile-study", "--warm-only",
                                          "--out", f"{tmp}/compile.json"],
            600, ("{", "wrote"))
        rec["compile-study"] = json.loads(
            Path(f"{tmp}/compile.json").read_text())["results"]
    rec["phase_s"] = time.time() - t0
    log("phase 30 took %.1f s; seconds by command: %s" % (
        rec["phase_s"], {k: round(v["s"], 2) for k, v in rec.items()
                         if isinstance(v, dict) and "s" in v}))
    return paths, rec


# -- phases 31-33: the host library, data-parallel training, the frontier --

def same_bits(a, b):
    """True iff two results (arrays, tuples of arrays, None or a string)
    are equal bit for bit."""
    if isinstance(a, tuple) or isinstance(b, tuple):
        return (isinstance(a, tuple) and isinstance(b, tuple)
                and len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                   np.ascontiguousarray(b).view(np.uint8)))
    return a == b


def host_ms(fn, reps=5):
    """Median host milliseconds of ``fn`` over ``reps`` runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_native(sim, timeline, main_e2e_s, main_fit_s, commands):
    """Phase 31: the host library (``circuitmap_torch/utils/native.py``)
    on the main map, each function at full size against its numpy
    version, bit for bit, with host ms (median of 5) of both: the stim
    sparsify of the 1000 x 20,000 stim (``solvers/_common._sparsify``,
    float64 in simulate's Fortran layout), the int4d2 and int8 encodes of the
    20,000 x 900 traces and the int4d2 decode (``utils/quant.py``'s
    calls), and the windows with their charges of phase 24's timeline
    (``utils/io.window_continuous_recording``'s call). Then the host
    stages the library now carries: ``profile-fit``'s stim upload and
    init and ``profile-demixer``'s host encode (phase 30), beside phase
    5's end to end and fit only."""
    from circuitmap_torch.solvers import _common
    from circuitmap_torch.utils import io, native, quant

    log("phase 31: the host library on the main map, native against "
        "plain (numpy), bit for bit")
    t0 = time.time()
    native.library()
    log(f"host library ready in {time.time() - t0:.2f} s "
        f"({'built' if native.built else 'cached'}, "
        f"{native.library_path().name})")
    stim, psc = sim["stim_matrix"], sim["psc"]
    levels = np.asarray((0.0, *POWERS), np.float32)
    packed, scale = quant.encode_int4_traces(psc, decimate=2)
    pscs, stim_times = timeline
    cases = [
        ("sparsify_stim", lambda: _common._sparsify(stim, levels),
         lambda: native.sparsify_stim_plain(
             stim, levels, _common.hologram_cap(stim.shape[0]))),
        ("encode_int4d2", lambda: quant.encode_int4_traces(psc, 2),
         lambda: native.encode_traces_int4_plain(psc, 2)),
        ("encode_int8", lambda: quant.quantise_int8(psc),
         lambda: native.encode_traces_int8_plain(psc)),
        ("decode_int4d2",
         lambda: quant.decode_int4_traces(packed, scale, psc.shape[1], 2),
         lambda: native.decode_traces_int4_plain(packed, scale,
                                                 psc.shape[1], 2)),
        ("extract_windows_with_charge",
         lambda: io.window_continuous_recording(pscs, stim_times,
                                                with_charge=True),
         lambda: native.extract_windows_with_charge_plain(pscs,
                                                          stim_times)),
    ]
    rec = {}
    for name, fast, plain in cases:
        got, want = fast(), plain()
        if not same_bits(got, want):
            raise AssertionError(f"host library {name}: not bit for bit its "
                                 "numpy version")
        rec[name] = dict(native_ms=host_ms(fast), plain_ms=host_ms(plain))
        log(f"{name}: bit for bit; native {rec[name]['native_ms']:.3f} ms, "
            f"plain {rec[name]['plain_ms']:.3f} ms "
            f"({rec[name]['plain_ms'] / rec[name]['native_ms']:.1f}x)")
    stages = commands["profile-fit"]["stages_best_ms"]
    rec["profile_fit_stim_prep_ms"] = stages["stim_prep"]
    rec["profile_demixer_host_encode_ms"] = commands["profile-demixer"][
        "host_encode_ms"]
    rec["main_e2e_s"], rec["main_fit_s"] = main_e2e_s, main_fit_s
    log(f"the stages it carries: profile-fit stim upload and init "
        f"{stages['stim_prep']:.3f} ms, profile-demixer host encode "
        f"{rec['profile_demixer_host_encode_ms']:.3f} ms; phase 5: end to "
        f"end {main_e2e_s:.4f} s, fit only {main_fit_s:.4f} s")
    return rec


MESH_TRAIN = ["cuda:0"] * 2  # phase 32's mesh: two shards of the card
# and a mesh of two devices, the card and the host: global BatchNorm's
# psums across replicas and their gradients' sum before each step
MESH_TRAIN_REPLICAS = ["cuda:0", "cpu"]


def phase_mesh_training(trained):
    """Phase 32: ``NeuralDemixer.train(mesh=["cuda:0"] * 2)`` on phase
    22's data (50,000 int4d2-wire pairs, lr 2e-3, batch 64), from
    demixers/nwd_ie_ChroME2f.npz. Shards on one device run as one part
    of the batch, so this mesh runs the one-device step; the first 3
    steps also run on ``MESH_TRAIN_REPLICAS`` (the card and the host,
    two replicas with the global batch's BatchNorm). Holds: the first 3
    steps (train on its first 3 batches' pairs) of both meshes within
    1e-4 of the state of the same steps on one device; one epoch's
    validation loss within 5% of the one-device epoch's. Prints each
    epoch's s and steps/s and the idle share of a profiled 100-step
    mesh epoch."""
    import torch
    from circuitmap_torch import NeuralDemixer
    from circuitmap_torch.parallel import trial_mesh

    log(f"phase 32: data-parallel demixer training, train(mesh="
        f"{MESH_TRAIN}), phase 22's data")
    mesh = trial_mesh(devices=MESH_TRAIN)
    (x_tr, y_tr), (x_te, y_te) = trained.training_data, trained.test_data
    lr, batch = 2e-3, 64

    def run(mesh, train, test, epochs=1, seed=0):
        d = NeuralDemixer(str(TRAIN_BASE))
        d.training_data, d.test_data = train, test
        torch.cuda.synchronize()
        t0 = time.time()
        hist = d.train(epochs=epochs, learning_rate=lr, batch_size=batch,
                       seed=seed, verbose=False, mesh=mesh)
        torch.cuda.synchronize()
        return d, hist, time.time() - t0

    rows = np.random.default_rng(0).permutation(x_tr.shape[0])[:3 * batch]
    few = (x_tr[rows], y_tr[rows])
    no_test = (x_te[:0], y_te[:0])
    one, _, _ = run(None, few, no_test)
    rec = {}
    for key, m in (("three_steps_rel", mesh),
                   ("three_steps_rel_replicas",
                    trial_mesh(devices=MESH_TRAIN_REPLICAS))):
        two, _, _ = run(m, few, no_test)
        rec[key] = rel = state_rel_diff(two.net.state_dict(),
                                        one.net.state_dict())
        log(f"3 steps, {m} vs one device: max |diff| / max |entry| over "
            f"the state {rel:.3e}")
        if rel > 1e-4:
            raise AssertionError(f"{m}'s first 3 training steps differ "
                                 f"from the one-device steps by {rel:.3e} "
                                 "> 1e-4")
    n_steps = x_tr.shape[0] // batch
    for name, m in (("single", None), ("mesh", mesh)):
        _, hist, secs = run(m, trained.training_data, trained.test_data)
        rec[name] = dict(epoch_s=secs, steps_per_s=n_steps / secs,
                         **hist[0])
        log(f"{name}: one epoch ({n_steps} steps) in {secs:.2f} s, "
            f"{n_steps / secs:.1f} steps/s; {hist[0]}")
    v1, v2 = rec["single"]["val_loss"], rec["mesh"]["val_loss"]
    if not abs(v2 - v1) <= 0.05 * abs(v1):
        raise AssertionError(f"mesh epoch's val loss {v2:.6f} is not within "
                             f"5% of the one-device epoch's {v1:.6f}")
    n_prof = PROFILED_STEPS * batch
    profiled(lambda: run(mesh, (x_tr[:n_prof], y_tr[:n_prof]), no_test,
                         seed=1),
             f"mesh_train_epoch_of_{PROFILED_STEPS}_steps")
    rec["profiled"] = getattr(profiled, "last", None)
    return rec


def phase_frontier():
    """Phase 33: the sweep-frontier study
    (``circuitmap_torch.scripts.sweep_frontier_study``) at N=1000,
    K=20000, seed 0, 50 iterations, every arm of its grid (blocks 1, 8,
    10, 12, 16 and perm8; the JAX study's xla8 has no counterpart), on
    the int4 wire with its QAT checkpoint. Holds: every arm's truth-R2
    >= 0.98. Returns (the launches of the study, its rows)."""
    import contextlib
    import io as _io
    import tempfile

    from circuitmap_torch.scripts import sweep_frontier_study as sf

    log("phase 33: the sweep-frontier study at N=1000, K=20000, seed 0")
    blocks = sf.grid(False)[2]
    qat = HERE / "demixers" / "nwd_ie_ChroME2f_int4qat.npz"
    reset_counts()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(_io.StringIO()):
        rows = sf.run_study([(N, K)], [0], blocks, 50, None,
                            f"{tmp}/frontier.json", str(qat))
    launches = kernel_launches(read_counts())
    log(f"{len(rows)} arms in {time.time() - t0:.1f} s; launches {launches}")
    for row in rows:
        log(f"  B={row['block']}: truth-R2 {row['r2']:.4f}, warm "
            f"{row['fit_warm_s']:.3f} s, cold {row['fit_cold_s']:.1f} s, "
            f"launches {row['launches']}")
    low = [r["block"] for r in rows if not r["r2"] >= 0.98]
    if low:
        raise AssertionError(f"frontier arms below truth-R2 0.98: {low}")
    return launches, rows


def main():
    try:
        import torch
    except ImportError:
        print("# torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("# CUDA is not available: chip_smoke.py needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from circuitmap_torch.ops import _build

    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    log("phase 2: build")
    t0 = time.time()
    _build.library()
    log(f"kernels ready in {time.time() - t0:.2f} s (nvcc build "
        f"{_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    sweep_rec, sweep_state = phase_sweep()
    laplace_rec = phase_laplace(sweep_state)
    del sweep_state
    epilogue_rec = phase_epilogue()
    wide = phase_blocks_and_levels()
    sweep_rec["pinned_blocks"] = wide["blocks"]
    sweep_rec["p16"] = wide["sweep_p16"]
    laplace_rec["p17"] = wide["laplace_p17"]
    repaired = phase_repaired_kernels()
    sweep_rec["many_levels"] = repaired["levels"]
    sweep_rec["long_blocks"] = repaired["blocks"]
    laplace_rec["many_buckets"] = repaired["laplace"]
    paths = {}
    (paths["main"], sim, dem, model, main_e2e_s,
     main_fit_s) = phase_main_path()
    laplace_profiled_ms = phase_profile(sim, dem)
    row_rec = phase_row_sweep()
    row_rec["p16_max_abs_err"] = wide["row_p16_max_abs_err"]
    sweep_rec["batched"], laplace_rec["batched"] = phase_batched_kernels()
    paths["block1_fit"] = phase_block1_fit(sim, dem)
    paths["auto_large_k"] = phase_large_k_fit()
    paths.update(phase_many(sim, dem))
    row_rec["solver_arguments"] = phase_solver_mappings()
    solvers = {}
    paths["sns"], solvers["cavi_sns"] = phase_sns(sim, dem)
    mbcs_paths, solvers["mbcs"] = phase_mbcs(sim, dem)
    paths.update(mbcs_paths)
    paths["ard"], solvers["mbcs_ard"] = phase_ard(sim, dem)
    elbo_paths, solvers["elbo"] = phase_elbo(sim, dem)
    paths.update(elbo_paths)
    paths["block16_fit"], solvers["block16"] = phase_block16_fit(sim, dem)
    paths["resumable"], solvers["resumable"] = phase_resumable(sim, dem)
    online_paths, solvers["online"] = phase_online(sim, dem)
    paths.update(online_paths)
    paths["closed_loop"], solvers["closed_loop"] = phase_closed_loop()
    many_paths, solvers["many_baselines"] = phase_many_baselines(sim, dem)
    paths.update(many_paths)
    fits, solvers["repaired_fits"] = phase_repaired_fits(sim, dem)
    paths.update(fits)
    trained, solvers["training"] = phase_training(sim, dem)
    solvers["template_fit"] = phase_template_fit(dem)
    (paths["continuous"], solvers["continuous"],
     timeline) = phase_continuous(trained)
    solvers["analysis"] = phase_analysis(sim, dem, model)
    serve_paths, solvers["serve"] = phase_serve(
        sim, dem, main_e2e_s, solvers["online"]["steady_median_ms"])
    paths.update(serve_paths)
    mesh_paths, solvers["mesh"] = phase_mesh(
        sim, dem, model, solvers["online"]["steady_median_ms"])
    paths.update(mesh_paths)
    wf_paths, solvers["workflows"] = phase_workflows(sim, dem, model)
    paths.update(wf_paths)
    f64_paths, f64_records, solvers["float64"] = phase_float64(sim, dem)
    paths.update(f64_paths)
    cmd_paths, solvers["commands"] = phase_commands()
    paths.update(cmd_paths)
    solvers["native"] = phase_native(sim, timeline, main_e2e_s, main_fit_s,
                                     solvers["commands"])
    del timeline
    solvers["mesh_training"] = phase_mesh_training(trained)
    paths["frontier"], solvers["frontier"] = phase_frontier()
    log(f"solvers: {json.dumps(solvers)}")
    laplace_rec["main_path_profiled_ms"] = laplace_profiled_ms
    records = (sweep_rec, laplace_rec, row_rec, epilogue_rec, *f64_records)
    for rec in records:
        # launches: the sum over the paths driven, each counted from 0
        rec["launches_by_path"] = {path: c.get(rec["name"], 0)
                                   for path, c in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        if rec["launches"] == 0:
            raise AssertionError(f"kernel {rec['name']} never launched")
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_by_path"]
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: v for k, v in r.items() if k not in keys}}
        for r in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
