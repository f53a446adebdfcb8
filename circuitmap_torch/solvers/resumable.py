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
                      stim_upload_plan, warn_data_thin_design,
                      warn_single_chip_envelope)
from ._laplace import resolve_laplace_impl
from .caviar import (CaviarState, _as, _reconnect_and_refit, _resolve_sweep,
                     _run_caviar, power_counts_of, seeded_generator)


def _check_shape(ck, N, K):
    lam_shape = np.shape(ck["lam"])
    if lam_shape != (N, K):
        raise ValueError(
            f"checkpoint holds a fit of {lam_shape[0]} neurons over "
            f"{lam_shape[1]} trials; this fit has N={N}, K={K}")


def _state_from_checkpoint(ck, dtype, device, N, K):
    """The CaviarState of a checkpoint's arrays, checked against the
    fit's N and K."""
    _check_shape(ck, N, K)
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

    With ``mesh`` (a ``parallel.TrialMesh``) the segments run the
    trial-sharded fit (``parallel.caviar_sharded``'s loop and schedule;
    ``device`` is then not used); the checkpoint holds the gathered
    state at the true trial count, so a fit may resume on another mesh.
    """
    if int(checkpoint_every) < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if int(iters) < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    # np.savez appends .npz; normalise so that the resume finds the file
    checkpoint_path = str(checkpoint_path)
    if not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    if mesh is not None:
        return _caviar_resumable_sharded(
            y_psc, stim, (mu_prior, beta_prior, shape_prior, rate_prior,
                          phi_prior, phi_cov_prior), checkpoint_path, mesh,
            iters=int(iters), checkpoint_every=int(checkpoint_every),
            seed=seed, y_xcorr_thresh=y_xcorr_thresh, fn_scan=fn_scan,
            dtype=dtype, powers=powers, sweep_impl=sweep_impl,
            sweep_block_size=sweep_block_size, laplace_impl=laplace_impl,
            trace_wire=trace_wire, verbose=verbose,
            loop=dict(num_mc_samples=int(num_mc_samples),
                      minimum_spike_count=int(minimum_spike_count),
                      delay_spont_est=int(delay_spont_est),
                      msrmp=float(msrmp), scale_factor=float(scale_factor),
                      penalty=float(penalty),
                      max_backtrack_iters=int(max_backtrack_iters),
                      tol=float(tol),
                      spont_orthogonality=float(spont_orthogonality),
                      analytic_mc=bool(analytic_mc)))
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    block = _resolve_sweep(sweep_impl, sweep_block_size, dev)
    resolve_laplace_impl(laplace_impl)

    warn_single_chip_envelope(*np.shape(stim), what="caviar_resumable()",
                              dtype=dtype, device=dev)
    stim_np, plan = stim_upload_plan(stim, powers)
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


def _caviar_resumable_sharded(y_psc, stim, priors, checkpoint_path, mesh, *,
                              iters, checkpoint_every, seed, y_xcorr_thresh,
                              fn_scan, dtype, powers, sweep_impl,
                              sweep_block_size, laplace_impl, trace_wire,
                              verbose, loop):
    """The segmented fit over a trial mesh: each segment runs
    ``parallel.sharded.run_sharded`` with global iteration numbers and
    the one generator; after it the gathered state, trimmed to the true
    K, and the generator state go to the checkpoint. A resume re-pads
    the checkpoint's trials for this mesh."""
    from ..parallel.distributed import state_from_host
    from ..parallel.sharded import (_fit_dtype, _hyper, _lam0, _prep,
                                    _require_local, _trim, finish,
                                    run_sharded)

    _require_local(mesh, "caviar_resumable(mesh=)")
    dtype = _fit_dtype(mesh, dtype)
    block = _resolve_sweep(sweep_impl, sweep_block_size, mesh.devices[0])
    resolve_laplace_impl(laplace_impl)
    d, K = _prep(y_psc, stim, mesh, dtype, y_xcorr_thresh, powers=powers,
                 trace_wire=trace_wire, what="caviar_resumable()")
    width = d.valid[0].shape[0] * mesh.n_local
    hyper = _hyper(mesh, dtype, *priors)
    generator = seeded_generator(seed, mesh.devices[0])
    start, state = 0, None
    if os.path.exists(checkpoint_path):
        ck = load_state(checkpoint_path)
        restore_generator(generator, ck.get(GENERATOR_KEY), checkpoint_path)
        start = int(ck["completed_iters"])
        _check_shape(ck, d.stim[0].shape[0], K)
        state = state_from_host(mesh, ck, slice(0, K), width, dtype)
        if verbose:
            print(f"Resuming sharded CAVIaR from iteration {start} "
                  f"({checkpoint_path}).")
    lam0 = _lam0(mesh, d, 0.95)
    while start < iters:
        seg = min(checkpoint_every, iters - start)
        state = run_sharded(mesh, d, hyper, generator, lam0, iters=seg,
                            start_iter=start, init_state=state,
                            sweep_block_size=block, **loop)[0]
        start += seg
        host = {f: v[0] for f, v in state._asdict().items()}
        host.update(lam=_trim(mesh, state.lam, K), z=_trim(mesh, state.z, K))
        save_state(checkpoint_path, {
            **host, GENERATOR_KEY: generator_state(generator),
            "completed_iters": np.asarray(start)})
        if verbose:
            print(f"checkpointed after iteration {start}/{iters}")
    mu, beta, lam, z, phi, phi_cov = finish(
        mesh, state, d, K, hyper, fn_scan, loop["msrmp"],
        loop["minimum_spike_count"], verbose)
    return (mu, beta, lam, state.shape[0], state.rate[0], phi, phi_cov, z,
            None, *[None] * 8)
