"""Multi-process trial-sharded fits (port of
``circuitmap_tpu/parallel/distributed.py``).

The sharded solvers (``sharded.py``) express every update as per-shard
work plus a ``psum``; over a :class:`TrialMesh` that carries a
``torch.distributed`` process group, each psum ends in one
``dist.all_reduce`` across the processes. This module supplies what a
fit larger than one process needs besides:

  * :func:`initialize` — an idempotent ``dist.init_process_group``,
  * :func:`global_trial_mesh` — this process's shards joined to the
    other processes' by the default group,
  * the ``*_distributed`` entry points — per-process trial feeding:
    each process passes only the trials it holds, in global trial order
    by rank (rank 0's trials first); three small metadata exchanges
    agree on the global trial count, the power set and the bucket
    counts, and ``gather_output=True`` gives every rank the full
    ``lam`` and ``z``.

Only ``all_reduce`` is used, on tensors on the mesh's first device:
gloo reduces CUDA tensors with all_reduce and broadcast only, so the
gathers of the outputs are all-reduces of zero-padded buffers, in
bounded chunks of the trial axis. NCCL needs one CUDA device per rank;
two ranks that share a card run under gloo, which the caller asks for.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..solvers._common import _powers_dev, _upload_plan
from ..solvers._laplace import resolve_laplace_impl
from ..solvers.caviar import (CaviarState, _resolve_sweep,
                              _validate_update_order, seeded_generator)
from .mesh import TrialMesh
from .sharded import (_fit_dtype, _hyper, _lam0, _pad_cols, observations,
                      power_counts_host, run_mbcs_sharded, run_sharded,
                      run_sns_sharded, shard_generators, shard_inputs)


def _local_rank(rank):
    return int(os.environ.get("LOCAL_RANK", rank))


def initialize(init_method=None, world_size=None, rank=None, backend=None,
               device=None):
    """Join (or start) the process group of a multi-process fit.
    Idempotent: a second call does nothing.

    ``init_method`` (e.g. ``"tcp://localhost:29500"``), ``world_size``
    and ``rank`` default to the environment that ``torchrun`` sets
    (``env://``). ``backend`` defaults to ``"nccl"`` when this rank's
    ``device`` is CUDA (None means CUDA, the package's device rule; the
    rank takes ``cuda:LOCAL_RANK``) and ``"gloo"`` for CPU ranks. NCCL
    refuses two ranks on one card: ranks that share a card pass
    ``backend="gloo"`` themselves.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    from .._device import resolve_device

    dev = resolve_device(device)
    kwargs = {"init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local = _local_rank(int(os.environ.get("RANK", rank or 0)))
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"NCCL needs one CUDA device per rank, but local rank "
                f"{local} sees {torch.cuda.device_count()} devices; ranks "
                "that share a card pass backend='gloo'")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kwargs)


def global_trial_mesh(devices=None):
    """This process's shards over the default process group: ``devices``
    (one per local shard; every rank must give the same count), by
    default the rank's own device (``cuda:LOCAL_RANK`` modulo the
    visible count; CPU ranks pass ``["cpu"]``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("call parallel.initialize_distributed() (or "
                           "torch.distributed.init_process_group) first")
    if devices is None:
        from .._device import resolve_device

        resolve_device(None)
        devices = [torch.device(
            "cuda", _local_rank(dist.get_rank()) % torch.cuda.device_count())]
    return TrialMesh(devices, group=dist.group.WORLD)


def _all_reduce(mesh, t):
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, group=mesh.group)
    return t


def _allgather_host(mesh, x):
    """[world, *x.shape] float64 host array of every rank's ``x``: an
    all-reduce of a buffer where each rank fills its own row."""
    x = np.asarray(x, np.float64)
    buf = torch.zeros((mesh.world,) + x.shape, dtype=torch.float64,
                      device=mesh.devices[0])
    buf[mesh.rank] = torch.from_numpy(x).to(buf.device)
    return _all_reduce(mesh, buf).cpu().numpy()


def _plan_shards(k_loc, mesh):
    """Agree on a common shard width across processes. Returns
    (rows per shard, this process's padded trials, the global trial
    count, every rank's true trial count in rank order)."""
    k_all = _allgather_host(mesh, [k_loc, mesh.n_local]).astype(np.int64)
    if not (k_all[:, 1] == mesh.n_local).all():
        raise ValueError("unequal local shard counts across processes: "
                         f"{k_all[:, 1].tolist()}")
    rows = int(max(-(-int(k) // mesh.n_local) for k in k_all[:, 0]))
    return rows, rows * mesh.n_local, int(k_all[:, 0].sum()), k_all[:, 0]


def _global_powers(mesh, stim_local, powers, np_dtype):
    """Union of the processes' stim levels, deduplicated at the fit
    dtype; with ``powers=`` the local levels are checked against the
    table instead (a level outside it would match no power bucket)."""
    loc = np.unique(stim_local[stim_local > 0]).astype(np.float64)
    if powers is None:
        max_levels = 64
        if loc.size > max_levels:
            raise ValueError(
                f"{loc.size} distinct stim levels on this process; pass "
                "powers= explicitly for continuously-varying designs")
        buf = np.zeros(max_levels)
        buf[:loc.size] = loc
        gathered = _allgather_host(mesh, buf).ravel()
        powers = np.unique(gathered[gathered > 0])
    else:
        powers = np.unique(np.asarray(powers, np.float64))
        missing = np.setdiff1d(loc.astype(np_dtype), powers.astype(np_dtype))
        if missing.size:
            raise ValueError(
                f"stim levels {missing.tolist()} on rank {mesh.rank} are "
                f"not in powers={powers.tolist()} — every stimulated level "
                "must be in the table (matching the single-process "
                "contract)")
    return np.unique(powers.astype(np_dtype)).astype(np.float64)


def _keep_mask(k_all, k_pad_loc):
    """Boolean mask over the gathered [.., K_pad_global] axis selecting
    the real trials, in rank order."""
    return np.concatenate([np.arange(k_pad_loc) < int(k) for k in k_all])


# bound on the transient buffer one gather chunk puts on the device
_GATHER_CHUNK_BYTES = 8e8


def _gather(mesh, shards, k_pad_loc, keep):
    """Every rank's trial-sharded ``shards`` ([.., Ks] each) as one host
    [.., K_global] array: all-reduces of zero-padded buffers in chunks
    of the trial axis (the same sequence on every rank), padding
    dropped by ``keep``."""
    local = mesh.gather(shards)
    lead = tuple(local.shape[:-1])
    total = k_pad_loc * mesh.world
    other = max(1, int(np.prod(lead)))
    block = max(1, int(_GATHER_CHUNK_BYTES // (other * local.element_size())))
    mine = (mesh.rank * k_pad_loc, (mesh.rank + 1) * k_pad_loc)
    outs = []
    for lo in range(0, total, block):
        hi = min(total, lo + block)
        buf = local.new_zeros(lead + (hi - lo,))
        a, b = max(lo, mine[0]), min(hi, mine[1])
        if a < b:
            buf[..., a - lo:b - lo] = local[..., a - mine[0]:b - mine[0]]
        outs.append(_all_reduce(mesh, buf).cpu().numpy())
    return np.concatenate(outs, axis=-1)[..., keep]


def _prep(psc_local, stim_local, mesh, dtype, y_xcorr_thresh, powers,
          trace_wire, mask="activity"):
    """Per-process preamble: agree on the shard plan and the power set,
    prepare this process's trials on its first device and the global
    bucket counts. ``mask`` as ``sharded.observations``. Returns (ShardData,
    plan dict)."""
    stim_local = np.asarray(stim_local)
    k_loc = np.shape(psc_local)[0]
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))
    rows, k_pad_loc, k_global, k_all = _plan_shards(k_loc, mesh)
    powers_dev = _global_powers(mesh, stim_local, powers, np_dtype)
    plan = _upload_plan(stim_local, powers_dev)
    powers_dev_np = _powers_dev(*plan[:3])
    y, lam_mask = observations(psc_local, mesh, dtype, y_xcorr_thresh,
                               trace_wire, mask)
    counts = _allgather_host(
        mesh, power_counts_host(stim_local, powers_dev_np, plan)).sum(0)
    d = shard_inputs(mesh, y, lam_mask, stim_local, plan, k_pad_loc, counts,
                     k_global, powers_dev_np, dtype)
    return d, dict(rows=rows, k_pad_loc=k_pad_loc, k_global=k_global,
                   k_all=k_all, keep=_keep_mask(k_all, k_pad_loc),
                   k_loc=k_loc)


def _resolve_mesh(mesh):
    return global_trial_mesh() if mesh is None else mesh


def _loop_options(mesh, num_mc_samples, minimum_spike_count,
                  delay_spont_est, msrmp, scale_factor, penalty,
                  max_backtrack_iters, tol, spont_orthogonality, analytic_mc,
                  sweep_block_size, laplace_impl, update_order):
    resolve_laplace_impl(laplace_impl)
    return dict(
        num_mc_samples=num_mc_samples,
        minimum_spike_count=minimum_spike_count,
        delay_spont_est=delay_spont_est, msrmp=msrmp,
        scale_factor=scale_factor, penalty=penalty,
        max_backtrack_iters=max_backtrack_iters, tol=tol,
        spont_orthogonality=spont_orthogonality, analytic_mc=analytic_mc,
        sweep_block_size=_resolve_sweep("auto", sweep_block_size,
                                        mesh.devices[0]),
        update_order=_validate_update_order(str(update_order)))


def _caviar_out(mesh, st, info, gather_output):
    rep = [st.mu[0], st.beta[0], st.shape[0], st.rate[0], st.phi[0],
           st.phi_cov[0]]
    mu, beta, shape, rate, phi, phi_cov = (t.cpu().numpy() for t in rep)
    if not gather_output:
        return (mu, beta, st.lam, shape, rate, phi, phi_cov, st.z, None)
    lam = _gather(mesh, st.lam, info["k_pad_loc"], info["keep"])
    z = _gather(mesh, st.z, info["k_pad_loc"], info["keep"])
    return (mu, beta, lam, shape, rate, phi, phi_cov, z, None)


def caviar_sharded_distributed(
    psc_local, stim_local, mu_prior, beta_prior, shape_prior, rate_prior,
    phi_prior, phi_cov_prior, mesh=None, iters=50, num_mc_samples=100,
    seed=0, y_xcorr_thresh=1e-2, minimum_spike_count=3, delay_spont_est=1,
    msrmp=0.3, scale_factor=0.75, penalty=5e0, max_backtrack_iters=20,
    tol=0.05, spont_orthogonality=0.1, dtype=torch.float32,
    analytic_mc=False, powers=None, sweep_block_size=1, laplace_impl="auto",
    update_order="random", trace_wire=None, gather_output=True,
    verbose=True,
):
    """Fit CAVIaR across processes, each feeding its own trials
    (``psc_local`` [K_local, T], ``stim_local`` [N, K_local]; the counts
    may differ; global trial order is rank order). The signature of
    ``circuitmap_tpu.parallel.caviar_sharded_distributed``; ``mesh``
    defaults to :func:`global_trial_mesh`. Returns ``(mu, beta, lam,
    shape, rate, phi, phi_cov, z, None)`` as numpy (``fn_scan=False``
    semantics); with ``gather_output=True`` every rank gets the full
    [N, K_global] ``lam`` and [K_global] ``z``, else each its per-shard
    lists."""
    mesh = _resolve_mesh(mesh)
    dtype = _fit_dtype(mesh, dtype)
    loop = _loop_options(mesh, num_mc_samples, minimum_spike_count,
                         delay_spont_est, msrmp, scale_factor, penalty,
                         max_backtrack_iters, tol, spont_orthogonality,
                         analytic_mc, sweep_block_size, laplace_impl,
                         update_order)
    d, info = _prep(psc_local, stim_local, mesh, dtype, y_xcorr_thresh,
                    powers, trace_wire)
    if verbose and mesh.rank == 0:
        print(f"Running CAVIaR over {mesh.world} processes / {mesh.size} "
              f"shards (K_global={info['k_global']}, rows/shard="
              f"{info['rows']}).")
    hyper = _hyper(mesh, dtype, mu_prior, beta_prior, shape_prior,
                   rate_prior, phi_prior, phi_cov_prior)
    st, _, _ = run_sharded(mesh, d, hyper,
                           seeded_generator(seed, mesh.devices[0]),
                           _lam0(mesh, d, 0.95), iters=int(iters), **loop)
    return _caviar_out(mesh, st, info, gather_output)


def caviar_resumable_distributed(
    psc_local, stim_local, mu_prior, beta_prior, shape_prior, rate_prior,
    phi_prior, phi_cov_prior, checkpoint_path, mesh=None, iters=50,
    checkpoint_every=10, num_mc_samples=100, seed=0, y_xcorr_thresh=1e-2,
    minimum_spike_count=3, delay_spont_est=1, msrmp=0.3, scale_factor=0.75,
    penalty=5e0, max_backtrack_iters=20, tol=0.05, spont_orthogonality=0.1,
    dtype=torch.float32, analytic_mc=False, powers=None, sweep_block_size=1,
    laplace_impl="auto", update_order="random", trace_wire=None,
    gather_output=True, verbose=True,
):
    """Segmented multi-process CAVIaR with checkpoint and resume (the
    contract of ``circuitmap_tpu.parallel.caviar_resumable_distributed``).

    After every ``checkpoint_every`` iterations the global state is
    gathered, trimmed to the true ``K_global`` and written atomically by
    rank 0, with the fit's generator state, in the format of
    ``solvers.caviar_resumable``: independent of the process count and
    mesh size, provided every process feeds the same global trial order.
    ``checkpoint_path`` must be writable by rank 0 and readable by every
    rank. Iterations are numbered globally, so the segments equal
    :func:`caviar_sharded_distributed` over the same ``iters``.
    """
    from ..utils.checkpoint import (GENERATOR_KEY, generator_state,
                                    load_state, restore_generator,
                                    save_state)

    if int(iters) < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if int(checkpoint_every) < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    checkpoint_path = str(checkpoint_path)
    if not checkpoint_path.endswith(".npz"):
        checkpoint_path += ".npz"
    mesh = _resolve_mesh(mesh)
    dtype = _fit_dtype(mesh, dtype)
    loop = _loop_options(mesh, num_mc_samples, minimum_spike_count,
                         delay_spont_est, msrmp, scale_factor, penalty,
                         max_backtrack_iters, tol, spont_orthogonality,
                         analytic_mc, sweep_block_size, laplace_impl,
                         update_order)
    d, info = _prep(psc_local, stim_local, mesh, dtype, y_xcorr_thresh,
                    powers, trace_wire)
    hyper = _hyper(mesh, dtype, mu_prior, beta_prior, shape_prior,
                   rate_prior, phi_prior, phi_cov_prior)
    generator = seeded_generator(seed, mesh.devices[0])
    head = verbose and mesh.rank == 0
    N = d.stim[0].shape[0]
    start, st = 0, None
    if os.path.exists(checkpoint_path):
        ck = load_state(checkpoint_path)
        restore_generator(generator, ck.get(GENERATOR_KEY), checkpoint_path)
        start = int(ck["completed_iters"])
        if np.shape(ck["lam"]) != (N, info["k_global"]):
            raise ValueError(
                f"checkpoint carries lam{np.shape(ck['lam'])} but this "
                f"cluster feeds [N={N}, K_global={info['k_global']}] "
                "trials — a resumed fit must see the same global trial set")
        off = int(info["k_all"][:mesh.rank].sum())
        cols = slice(off, off + info["k_loc"])
        st = state_from_host(mesh, ck, cols, info["k_pad_loc"], dtype)
        if head:
            print(f"Resuming distributed CAVIaR from iteration {start} "
                  f"({checkpoint_path}).")
    lam0 = _lam0(mesh, d, 0.95)
    while start < int(iters):
        seg = min(int(checkpoint_every), int(iters) - start)
        st, _, _ = run_sharded(mesh, d, hyper, generator, lam0, iters=seg,
                               start_iter=start, init_state=st, **loop)
        start += seg
        host = _caviar_out(mesh, st, info, True)
        if mesh.rank == 0:
            save_state(checkpoint_path, {
                **dict(zip(("mu", "beta", "lam", "shape", "rate", "phi",
                            "phi_cov", "z"), host[:8])),
                "spont_rate": st.spont_rate[0],
                GENERATOR_KEY: generator_state(generator),
                "completed_iters": np.asarray(start)})
        if head:
            print(f"checkpointed after iteration {start}/{iters}")
    return _caviar_out(mesh, st, info, gather_output)


def state_from_host(mesh, ck, cols, width, dtype):
    """A sharded CaviarState from a checkpoint's global arrays: the
    trial columns ``cols`` of lam and z (this process's), zero-padded to
    ``width`` and split over the shards; the rest replicated."""
    dev0 = mesh.devices[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=dev0).to(dtype)

    return CaviarState(
        **{f: mesh.replicate(t(ck[f])) for f in
           ("mu", "beta", "shape", "rate", "phi", "phi_cov", "spont_rate")},
        lam=mesh.split(_pad_cols(t(np.asarray(ck["lam"])[:, cols]), width)),
        z=mesh.split(_pad_cols(t(np.asarray(ck["z"])[cols]), width)))


def cavi_sns_sharded_distributed(
    psc_local, stim_local, mu_prior, beta_prior, alpha_prior, shape_prior,
    rate_prior, phi_prior, phi_cov_prior, mesh=None, iters=50,
    num_mc_samples=100, seed=1, minimum_spike_count=3, dtype=torch.float32,
    analytic_mc=False, powers=None, laplace_impl="auto", trace_wire=None,
    update_order="random", gather_output=True, verbose=True,
):
    """CAVI-SnS across processes, each feeding its own trials; the
    contract of ``circuitmap_tpu.parallel.cavi_sns_sharded_distributed``
    plus ``update_order``: returns ``(mu, beta, alpha, lam, shape, rate,
    phi, phi_cov)`` as numpy. No trial activity mask applies."""
    mesh = _resolve_mesh(mesh)
    dtype = _fit_dtype(mesh, dtype)
    resolve_laplace_impl(laplace_impl)
    d, info = _prep(psc_local, stim_local, mesh, dtype, None, powers,
                    trace_wire, mask="none")
    if verbose and mesh.rank == 0:
        print(f"Running CAVI-SnS over {mesh.world} processes / {mesh.size} "
              f"shards (K_global={info['k_global']}).")
    hyper = _hyper(mesh, dtype, mu_prior, beta_prior, alpha_prior,
                   shape_prior, rate_prior, phi_prior, phi_cov_prior)
    st, _ = run_sns_sharded(
        mesh, d, hyper, seeded_generator(seed, mesh.devices[0]),
        _lam0(mesh, d, 0.95), iters=int(iters),
        num_mc_samples=num_mc_samples,
        minimum_spike_count=minimum_spike_count, analytic_mc=analytic_mc,
        save_histories=False,
        update_order=_validate_update_order(str(update_order)))
    out = [x[0].cpu().numpy() for x in (st.mu, st.beta, st.alpha)]
    rest = [x[0].cpu().numpy() for x in (st.shape, st.rate, st.phi,
                                         st.phi_cov)]
    lam = (_gather(mesh, st.lam, info["k_pad_loc"], info["keep"])
           if gather_output else st.lam)
    return (*out, lam, *rest)


def mbcs_sharded_distributed(
    psc_local, stim_local, mu_prior, beta_prior, shape_prior, rate_prior,
    mesh=None, iters=50, seed=0, y_xcorr_thresh=0.05, penalty=5e0,
    scale_factor=0.5, max_penalty_iters=10, max_lasso_iters=100,
    constrain_weights="positive", learn_lam=True, delay_spont_estimation=1,
    minimum_spike_count=1, noise_scale=0.5, num_mc_samples_noise_model=10,
    minimum_maximal_spike_prob=0.2, orthogonal_outliers=True,
    outlier_penalty=5e1, init_spike_prior=0.75, outlier_tol=0.05,
    spont_rate=0, lam_mask_fraction=0.05, dtype=torch.float32,
    analytic_noise=False, powers=None, trace_wire=None, gather_output=True,
    verbose=True,
):
    """MBCS across processes, each feeding its own trials; the contract
    of ``circuitmap_tpu.parallel.mbcs_sharded_distributed``: returns
    ``(mu, beta, lam, shape, rate, z, receptive_fields)`` as numpy. The
    activity mask's relative-peak cut uses the global trace peak (one
    scalar exchange)."""
    from ..solvers.mbcs import fit_params

    mesh = _resolve_mesh(mesh)
    dtype = _fit_dtype(mesh, dtype)
    psc_np = np.asarray(psc_local)
    energy = np.sum(psc_np * psc_np, axis=-1)
    local_max = psc_np.max() if psc_np.shape[0] else 0.0
    global_max = float(_allgather_host(mesh, [local_max]).max())
    mask = (energy > y_xcorr_thresh).astype(np.float64)
    mask[np.max(psc_np, axis=1) < lam_mask_fraction * global_max] = 0.0
    d, info = _prep(psc_np, stim_local, mesh, dtype, None, powers,
                    trace_wire, mask=mask)
    if verbose and mesh.rank == 0:
        print(f"Running MBCS over {mesh.world} processes / {mesh.size} "
              f"shards (K_global={info['k_global']}).")
    params = fit_params(
        penalty=penalty, scale_factor=scale_factor,
        max_penalty_iters=max_penalty_iters, max_lasso_iters=max_lasso_iters,
        constrain_weights=constrain_weights, learn_lam=learn_lam,
        delay_spont_estimation=delay_spont_estimation,
        minimum_spike_count=minimum_spike_count,
        num_mc_samples_noise_model=num_mc_samples_noise_model,
        orthogonal_outliers=orthogonal_outliers,
        analytic_noise=analytic_noise, outlier_penalty=outlier_penalty,
        minimum_maximal_spike_prob=minimum_maximal_spike_prob,
        outlier_tol=outlier_tol, noise_scale=noise_scale)
    dev0 = mesh.devices[0]
    N = d.stim[0].shape[0]
    mu0 = torch.as_tensor(np.random.default_rng(seed).lognormal(1.0, 1.0, N),
                          device=dev0).to(dtype)
    (mu, beta, lam, shape, rate, z, _), rf, _ = run_mbcs_sharded(
        mesh, d, _lam0(mesh, d, float(init_spike_prior)),
        mesh.replicate(mu0), _hyper(mesh, dtype, beta_prior)[0],
        mesh.map(lambda yy: torch.full_like(yy, float(shape_prior)), d.y),
        mesh.map(lambda yy: torch.full_like(yy, float(rate_prior)), d.y),
        mesh.replicate(torch.tensor(float(spont_rate), dtype=dtype,
                                    device=dev0)),
        seeded_generator(seed, dev0), shard_generators(mesh, seed), params,
        iters=iters, save_histories=False)
    mu, beta, rf = (x[0].cpu().numpy() for x in (mu, beta, rf))
    if not gather_output:
        return (mu, beta, lam, shape, rate, z, rf)
    lam, shape, rate, z = (_gather(mesh, x, info["k_pad_loc"], info["keep"])
                           for x in (lam, shape, rate, z))
    return (mu, beta, lam, shape, rate, z, rf)
