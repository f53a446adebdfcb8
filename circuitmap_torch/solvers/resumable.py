"""Checkpointed CAVIaR: the fit in segments, resumable from its last
checkpoint (port of ``circuitmap_tpu/solvers/resumable.py``).

The fit runs ``checkpoint_every`` iterations at a time; after each
segment the state, the fit's random stream (its ``torch.Generator``) and
the count of completed iterations go to one ``.npz``
(``utils/checkpoint.py``). A call that finds the file resumes after its
last segment. The segments number their iterations globally
(``_run_caviar``'s ``start_iter``) and continue one random stream, so a
segmented fit, interrupted or not, is the one-shot ``caviar()`` fit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..ops.charge import prepare_observations
from ..utils.checkpoint import (GENERATOR_KEY, generator_state, load_state,
                                restore_generator, save_state)
from ._common import (prepare_stim_and_init, prepare_traces,
                      stim_upload_plan, warn_data_thin_design)
from ._laplace import resolve_laplace_impl
from .caviar import (CaviarState, _as, _reconnect_and_refit, _resolve_sweep,
                     _run_caviar, power_counts_of, seeded_generator)


def _state_from_checkpoint(ck, dtype, device, N, K):
    """The CaviarState of a checkpoint's arrays, checked against the
    fit's N and K."""
    lam = np.asarray(ck["lam"])
    if lam.shape != (N, K):
        raise ValueError(
            f"checkpoint holds a fit of {lam.shape[0]} neurons over "
            f"{lam.shape[1]} trials; this fit has N={N}, K={K}")
    return CaviarState(**{f: _as(ck[f], dtype, device)
                          for f in CaviarState._fields})


def caviar_resumable(
    y_psc, stim, mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
    phi_cov_prior, checkpoint_path, iters=50, checkpoint_every=10, seed=0,
    num_mc_samples=100, y_xcorr_thresh=1e-2, minimum_spike_count=3,
    delay_spont_est=1, msrmp=0.3, scale_factor=0.75, penalty=5e0,
    max_backtrack_iters=20, tol=0.05, spont_orthogonality=0.1, fn_scan=True,
    dtype=torch.float32, analytic_mc=False, mesh=None, powers=None,
    sweep_impl="auto", sweep_block_size="auto", laplace_impl="auto",
    trace_wire=None, verbose=True, device=None,
):
    """CAVIaR with a checkpoint after every ``checkpoint_every``
    iterations; the signature of
    ``circuitmap_tpu.solvers.caviar_resumable`` plus ``device`` (None
    means CUDA; the package's device rule).

    If ``checkpoint_path`` (``.npz`` appended when missing) exists, the
    fit resumes after the iterations it records; a checkpoint written by
    the JAX package raises (it holds a ``jax.random`` key, not the
    port's generator state). After the last segment come the
    reconnection scan and, if it changed lam, the refit. Returns
    ``caviar()``'s tuple (tensors on the fit's device; receptive fields
    and the eight histories None: histories are not kept across
    segments).

    ``mesh=`` (the trial-sharded multi-device fit) is ROADMAP item A9,
    not ported yet.
    """
    if int(checkpoint_every) < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if int(iters) < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the trial-sharded resumable fit) is ROADMAP item A9 and "
            "not ported yet")
    # np.savez appends .npz; normalise so that the resume finds the file
    checkpoint_path = str(checkpoint_path)
    if not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    if dev.type == "cuda" and dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA kernels of this version take float32 only; a "
            f"{dtype} fit runs with device='cpu'")
    block = _resolve_sweep(sweep_impl, sweep_block_size, dev)
    resolve_laplace_impl(laplace_impl)

    stim_np, plan = stim_upload_plan(stim, powers, dev)
    y_psc = prepare_traces(y_psc, dtype, dev, trace_wire=trace_wire)
    y, active = prepare_observations(y_psc, y_xcorr_thresh)
    stim_t, lam_mask, lam0, _, _, powers_dev_np, pc_np = prepare_stim_and_init(
        stim_np, active, dtype, dev, plan)
    warn_data_thin_design(pc_np, stim_t.shape[1], what="caviar_resumable()")
    powers_t = _as(powers_dev_np, dtype, dev)
    hyper = tuple(_as(a, dtype, dev) for a in (
        mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
        phi_cov_prior))
    generator = seeded_generator(seed, dev)

    start, state = 0, None
    if os.path.exists(checkpoint_path):
        ck = load_state(checkpoint_path)
        restore_generator(generator, ck.get(GENERATOR_KEY), checkpoint_path)
        start = int(ck["completed_iters"])
        state = _state_from_checkpoint(ck, dtype, dev, *stim_t.shape)
        if verbose:
            print(f"Resuming CAVIaR from iteration {start} "
                  f"({checkpoint_path}).")

    loop = dict(
        num_mc_samples=int(num_mc_samples),
        minimum_spike_count=int(minimum_spike_count),
        delay_spont_est=int(delay_spont_est), msrmp=float(msrmp),
        scale_factor=float(scale_factor), penalty=float(penalty),
        max_backtrack_iters=int(max_backtrack_iters), tol=float(tol),
        spont_orthogonality=float(spont_orthogonality),
        analytic_mc=bool(analytic_mc), save_histories=False,
        sweep_block_size=block, update_order="random")
    counts = power_counts_of(stim_t, powers_t, dtype)
    while start < int(iters):
        seg = min(int(checkpoint_every), int(iters) - start)
        state = _run_caviar(
            y, stim_t, lam0, lam_mask, powers_t, counts, hyper, [generator],
            iters=seg, start_iter=start, init_state=state, **loop)[0]
        start += seg
        save_state(checkpoint_path, {
            **state._asdict(), GENERATOR_KEY: generator_state(generator),
            "completed_iters": np.asarray(start)})
        if verbose:
            print(f"checkpointed after iteration {start}/{iters}")

    mu, beta, lam, shape, rate, phi, phi_cov, z, _ = state
    if fn_scan:
        mu, beta, lam, z, phi, phi_cov, n_rec = _reconnect_and_refit(
            stim_t, lam, mu, beta, z, powers_t, phi, phi_cov, hyper[4],
            hyper[5], float(msrmp), float(minimum_spike_count))
        if verbose:
            print(f"Reconnected {n_rec} neurons previously attributed to "
                  "spontaneous activity.")
    return (mu, beta, lam, shape, rate, phi, phi_cov, z, None, *[None] * 8)
