"""Batched fits: many experiments at once (port of
``circuitmap_tpu/solvers/batched.py``: ``caviar_many``, ``sns_many``,
``mbcs_many``).

Mapping sessions produce stacks of problems of one shape:
cross-validation folds, repeated maps of one field of view, parameter
sweeps. ``caviar_many`` fits B of them, in one of two modes:

* ``"sequential"`` (the default): the single fit's loop once per
  experiment, with the single fit's sweep;
* ``"batched"``: one loop over the whole stack (a leading experiment
  axis on every update, batched Cholesky and products), whose sweep is
  one launch of the batched row kernel (``"auto"``, block 1) or of the
  batched blocked kernel (block 8) per iteration, and whose Laplace
  refit is one launch for all B x N neurons.

Experiments share N, T and the power levels. A ragged list (different
trial counts) is padded to the stack's largest K with inert columns
(zero traces, stim and mask) and fit with each experiment's true trial
count ``k_true`` where the fit counts trials; results come back at each
experiment's true width. Each experiment draws its row orders and Monte
Carlo samples from its own generator seeded from ``seeds[b]``, in the
sequence of ``caviar(seed=seeds[b])``.

``sns_many`` and ``mbcs_many`` take the same modes for CAVI-SnS and
MBCS. Their batched loops are the single fits' loops with an experiment
axis (``cavi_sns._run_sns``: the batched row kernel and one batched
Laplace launch an iteration; ``mbcs._run_mbcs``: FISTA over [E, N, N]).
A ragged list runs each experiment's own single fit at its true shape.

All three take ``mesh=`` (a ``parallel.TrialMesh``): the experiment
axis shards over the mesh's devices, each running the batched loop on
its chunk with no collective.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..ops.charge import integrated_charge, prepare_observations
from ..utils.profiling import span
from ..utils.pull import to_host
from ..utils.quant import PackedInt4Traces
from ._common import (_levels, _powers_dev, _stim_on_device, _upload_plan,
                      prepare_traces, warn_single_chip_envelope)
from ._laplace import laplace_phi_update, resolve_laplace_impl
from .caviar import (_as, _reconnect_scan_device, _resolve_sweep,
                     _run_caviar, _validate_update_order, power_counts_of,
                     seeded_generator)

FIELDS = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")


def _ragged_lists(y_pscs, stims, name):
    """``(ys_list, st_list, ks)`` when ``y_pscs`` is a list or tuple of
    [K_b, T] host arrays with differing trial counts, else None (a
    same-K list takes the stacked path)."""
    if not (isinstance(y_pscs, (list, tuple)) and len(y_pscs) > 0):
        return None
    ks = [int(np.shape(a)[0]) for a in y_pscs]
    if len(set(ks)) <= 1:
        return None
    if any(isinstance(a, (torch.Tensor, PackedInt4Traces)) for a in y_pscs):
        raise ValueError(
            f"{name}: ragged batches take host trace arrays; device "
            "tensors and int4 wire bodies must share one shape")
    if not isinstance(stims, (list, tuple)) or len(stims) != len(y_pscs):
        raise ValueError(
            f"ragged y_pscs ({len(y_pscs)} experiments) needs a "
            "matching list of per-experiment [N, K_b] stims")
    ys_list = [np.asarray(a) for a in y_pscs]
    st_list = [np.asarray(s) for s in stims]
    t_len = ys_list[0].shape[1] if ys_list[0].ndim == 2 else -1
    n_cells = st_list[0].shape[0] if st_list[0].ndim == 2 else -1
    for b, (a, s) in enumerate(zip(ys_list, st_list)):
        if a.ndim != 2 or a.shape[1] != t_len:
            raise ValueError(
                f"experiment {b}: traces must be [K_b, {t_len}], "
                f"got {a.shape}")
        if s.shape != (n_cells, a.shape[0]):
            raise ValueError(
                f"experiment {b}: stim must be "
                f"[{n_cells}, {a.shape[0]}], got {s.shape}")
    return ys_list, st_list, ks


def _same_shape_stack(y_pscs, stims, trace_wire, dtype):
    """Same-shape inputs as (traces, stims_np). A tensor stays as it is
    (a device-resident demixer output is not pulled), as does an int4
    wire body (``PackedInt4Traces``, unpacked on the device); host traces
    on the exact wire go up as float32 unless the fit is wider (a
    float64 fit keeps its mantissa in transit); compressed wires cast
    inside prepare_traces."""
    if isinstance(y_pscs, (torch.Tensor, PackedInt4Traces)):
        return y_pscs, np.asarray(stims)
    if trace_wire is None and dtype.itemsize <= 4:
        return np.asarray(y_pscs, dtype=np.float32), np.asarray(stims)
    return np.asarray(y_pscs), np.asarray(stims)


def _validate_shared_levels(stims_np, powers):
    """The shared power levels, from experiment 0 (or ``powers``). Above
    127 levels the upload is dense and checks no coverage, so every
    other experiment is checked against them here."""
    powers_np, levels_np = _levels(stims_np[0], powers)
    if levels_np.size > 127:
        table = np.concatenate([[0.0], powers_np])
        for b in range(1, stims_np.shape[0]):
            extra = np.setdiff1d(np.unique(stims_np[b]), table)
            if extra.size:
                raise ValueError(
                    "all experiments must share the same power levels: "
                    f"experiment {b} contains values {extra[:5].tolist()} "
                    "outside experiment 0's level table")
    return powers_np


def _upload_trace_stack(y_pscs, dtype, trace_wire, device):
    """[B, K, T] traces on ``device``: a tensor is moved and cast there;
    an int4 wire body goes up as its codes (one flattened device
    unpack); a host array ships at its own width and widens on the
    device, or through prepare_traces' compressed wire when one is asked
    for."""
    if isinstance(y_pscs, (torch.Tensor, PackedInt4Traces)):
        return prepare_traces(y_pscs, dtype, device, trace_wire=trace_wire)
    if trace_wire is None:
        host = torch.from_numpy(np.ascontiguousarray(y_pscs))
        return host.to(device).to(dtype)
    B, K, T = y_pscs.shape
    return prepare_traces(y_pscs.reshape(B * K, T), dtype, device,
                          trace_wire=trace_wire).reshape(B, K, T)


def _upload_stim_stack(stims_np, dtype, powers_np, device):
    """Each experiment's stim in its compressed upload (sparse hologram
    or int8 buckets), rebuilt and stacked on the device. Returns
    (stim_dev [B, N, K], powers_dev_np); raises unless every experiment
    is covered by the shared level table."""
    rows, powers_dev_np = [], None
    for b in range(stims_np.shape[0]):
        try:
            ph, lv, kind, payload = _upload_plan(stims_np[b], powers_np)
        except ValueError as e:
            raise ValueError(
                "all experiments must share the same power levels: "
                f"experiment {b} contains values outside experiment 0's "
                f"levels {np.asarray(powers_np).tolist()}") from e
        rows.append(_stim_on_device(stims_np[b], lv, kind, payload, dtype,
                                    device))
        if powers_dev_np is None:
            powers_dev_np = _powers_dev(ph, lv, kind)
    return torch.stack(rows), powers_dev_np


def _many_init(stim_dev, actives):
    """(lam_masks [B, K], lam0 [B, N, K]): lam0 = 0.95 on targeted
    active trials, as the single fit starts."""
    lam_masks = actives.to(stim_dev.dtype)
    return lam_masks, (stim_dev > 0).to(stim_dev.dtype) * 0.95 * \
        lam_masks[:, None, :]


def _many_init_ragged(ys, actives, stim_dev, kts):
    """_many_init with true trial counts ``kts`` [B]: charges, stim and
    activity masks are zeroed from each k_true on, so padded columns
    are inert whatever the caller left in them."""
    valid = torch.arange(ys.shape[-1], device=ys.device)[None] < kts[:, None]
    ys = torch.where(valid, ys, 0.0)
    stim_dev = torch.where(valid[:, None, :], stim_dev, 0.0)
    return (ys, stim_dev) + _many_init(stim_dev, actives & valid)


def _resolve_mode(compile_mode, mesh):
    """The mode that runs: 'auto' is 'sequential' without a mesh and
    'batched' under one; 'sequential' has no mesh path (experiment
    sharding runs the batched loop on each shard's chunk)."""
    if compile_mode not in ("auto", "sequential", "batched"):
        raise ValueError(
            f"compile_mode must be 'auto', 'sequential' or 'batched'; "
            f"got {compile_mode!r}")
    if compile_mode == "sequential" and mesh is not None:
        raise ValueError(
            "compile_mode='sequential' has no mesh path — experiment "
            "sharding needs the batched loop; drop mesh= or use "
            "compile_mode='batched'")
    if compile_mode == "auto":
        return "sequential" if mesh is None else "batched"
    return compile_mode


def _fit_device(mesh, device):
    """The device the stack is uploaded to: the mesh's first device, or
    ``device`` (the package's device rule) without a mesh."""
    if mesh is None:
        return resolve_device(device)
    from ..parallel.sharded import _require_local

    _require_local(mesh, "*_many(mesh=)")
    return mesh.devices[0]


def _mesh_chunks(mesh, B, run):
    """The experiment axis sharded over the mesh, with no collective:
    shard s fits a contiguous chunk of the B experiments on its device
    (``run(indices, device)`` -> a sequence of [chunk, ...] tensors; B is
    padded to a multiple of the shard count by repeating the last
    experiment). Returns each result stacked over the B experiments on
    the mesh's first device."""
    n = mesh.n_local
    per = -(-B // n)
    idx = np.minimum(np.arange(per * n), B - 1).reshape(n, per)
    outs = [run(torch.as_tensor(idx[s]), d)
            for s, d in enumerate(mesh.devices)]
    dev0 = mesh.devices[0]
    return [torch.cat([o[f].to(dev0) for o in outs])[:B]
            for f in range(len(outs[0]))]


def _on(device, *arrays):
    return tuple(a.to(device) for a in arrays)


def _device_stack(y_pscs, stims_np, k_trues, powers_np, y_xcorr_thresh,
                  dtype, trace_wire, device):
    """Upload the stack and build the loop's inputs: (ys [B, K],
    stim_dev [B, N, K], lam_masks [B, K], lam0 [B, N, K], powers [P],
    kts [B] or None)."""
    y_dev = _upload_trace_stack(y_pscs, dtype, trace_wire, device)
    stim_dev, powers_dev_np = _upload_stim_stack(stims_np, dtype, powers_np,
                                                 device)
    ys, actives = prepare_observations(y_dev, y_xcorr_thresh)
    kts = None
    if k_trues is None:
        lam_masks, lam0 = _many_init(stim_dev, actives)
    else:
        kts = torch.as_tensor(k_trues, device=device)
        ys, stim_dev, lam_masks, lam0 = _many_init_ragged(ys, actives,
                                                          stim_dev, kts)
        kts = kts.to(dtype)
    return ys, stim_dev, lam_masks, lam0, _as(powers_dev_np, dtype,
                                              device), kts


@span("cm.many")
def caviar_many(
    y_pscs, stims, mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
    phi_cov_prior, iters=50, seeds=None, num_mc_samples=100,
    y_xcorr_thresh=1e-2, minimum_spike_count=3, delay_spont_est=1,
    msrmp=0.3, scale_factor=0.75, penalty=5e0, max_backtrack_iters=20,
    tol=0.05, spont_orthogonality=0.1, fn_scan=True, dtype=torch.float32,
    analytic_mc=False, mesh=None, powers=None, sweep_block_size="auto",
    laplace_impl="auto", compile_mode="auto", trace_wire=None, k_trues=None,
    verbose=True, update_order="random", device=None,
):
    """Fit B experiments. y_pscs: [B, K, T] (host array or tensor);
    stims: [B, N, K]. The signature of
    ``circuitmap_tpu.solvers.caviar_many`` plus ``update_order`` (as
    ``caviar``: "random", each experiment's rows in an order drawn from
    its generator, or "identity", in index order, which with
    ``analytic_mc=True`` makes each fit a function of its inputs) and
    ``device`` (None means CUDA; the package's device rule).

    Priors are shared. Returns a list of B dicts of numpy arrays with
    keys mu/beta/lam/shape/rate/phi/phi_cov/z, each at its experiment's
    true width.

    A ragged stack is a list of [K_b, T] trace arrays with a matching
    list of [N, K_b] stims; ``k_trues`` instead marks an already padded
    [B, K, T] stack (columns from each k_true on are masked out on the
    device, and stim must be zero there). Either way each experiment
    matches its single fit to the inert-padding tolerance (sums over
    more columns round differently), not bit for bit.

    ``compile_mode``: "sequential" ("auto" without a mesh) runs the single fit's
    loop per experiment, "batched" one loop over the stack. Under
    ``sweep_block_size="auto"`` the batched loop runs the strictly
    sequential sweep (block 1, the batched row kernel on CUDA) and the
    sequential mode resolves as ``caviar()`` does (block 8 on CUDA at any
    K, 1 on the CPU). A pinned block size is the same
    in both modes, and they then agree to float rounding.

    After the fits, ``fn_scan`` runs the reconnection scan per
    experiment on the device and one batched Laplace refit over the
    experiments it changed.

    ``mesh`` (a ``parallel.TrialMesh``) shards the *experiment* axis:
    each shard runs the batched loop on a contiguous chunk of the
    experiments on its device, with no collective ("auto" is then
    "batched"; "sequential" raises). Results come back on the host as
    without a mesh.

    The call is one ``cm.many`` span, its stages ``cm.many.stim`` (the
    stack's upload and observations), ``.loop``, ``.scan`` (the
    reconnection scans and the refit) and ``.pull`` in that order.
    """
    dev = _fit_device(mesh, device)
    dtype = torch_dtype(dtype)
    update_order = _validate_update_order(str(update_order))
    if k_trues is not None:
        k_trues = np.asarray(k_trues, dtype=np.int64)
    from_list = False  # a ragged list, padded here with zero stim
    ragged_in = _ragged_lists(y_pscs, stims, "caviar_many")
    if ragged_in is not None:
        if k_trues is not None:
            raise ValueError(
                "pass EITHER a ragged list of experiments OR k_trues= with "
                "an already-padded stack, not both")
        ys_list, st_list, ks = ragged_in
        k_pad = max(ks)  # no alignment padding: only the stack's largest K
        t_dt = (np.float64 if dtype.itemsize > 4
                and any(a.dtype == np.float64 for a in ys_list)
                else np.float32)
        y_pad = np.zeros((len(ys_list), k_pad, ys_list[0].shape[1]), t_dt)
        s_pad = np.zeros((len(st_list), st_list[0].shape[0], k_pad),
                         np.result_type(*[s.dtype for s in st_list]))
        for b, (a, s) in enumerate(zip(ys_list, st_list)):
            y_pad[b, :ks[b]] = a
            s_pad[b, :, :ks[b]] = s
        y_pscs, stims = y_pad, s_pad
        k_trues = np.asarray(ks, np.int64)
        from_list = True

    y_pscs, stims_np = _same_shape_stack(y_pscs, stims, trace_wire, dtype)
    B, K, _T = y_pscs.shape
    if mesh is None:  # a mesh's per-device share is its own business
        warn_single_chip_envelope(
            B * stims_np.shape[1], K,
            what=f"caviar_many() over {B} experiments", dtype=dtype,
            device=dev)
    if k_trues is not None:
        if (k_trues.shape != (B,) or int(k_trues.min(initial=1)) < 1
                or int(k_trues.max(initial=1)) > K):
            raise ValueError(
                f"k_trues must be [B={B}] trial counts in [1, {K}]; got "
                f"shape {k_trues.shape}, range "
                f"[{k_trues.min(initial=0)}, {k_trues.max(initial=0)}]")
        if not from_list:
            # padded stim columns must be zero: they enter the level scan
            for b in range(B):
                if np.any(stims_np[b][:, int(k_trues[b]):]):
                    raise ValueError(
                        f"experiment {b}: stim columns at or beyond "
                        f"k_trues[{b}]={int(k_trues[b])} must be zero "
                        "(padding enters the power-level scan)")
    mode = _resolve_mode(compile_mode, mesh)
    resolve_laplace_impl(laplace_impl)
    block = (1 if mode == "batched" and sweep_block_size == "auto"
             else _resolve_sweep("auto", sweep_block_size, dev, k=K))
    powers_np = _validate_shared_levels(stims_np, powers)
    if verbose:
        ragged = ("" if k_trues is None else
                  f", ragged trials {k_trues.min()}-{k_trues.max()} "
                  f"padded to {K}")
        print(f"Running CAVIaR (PyTorch) on {B} experiments "
              f"(compile_mode={mode}, sweep block {block}{ragged}).")

    with span("cm.many.stim"):
        ys, stim_dev, lam_masks, lam0, powers_t, kts = _device_stack(
            y_pscs, stims_np, k_trues, powers_np, y_xcorr_thresh, dtype,
            trace_wire, dev)
    hyper = tuple(_as(a, dtype, dev) for a in (
        mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
        phi_cov_prior))
    counts = power_counts_of(stim_dev, powers_t, dtype)
    seeds = np.arange(B) if seeds is None else seeds
    gens = [seeded_generator(s, dev) for s in seeds]
    loop = dict(
        iters=int(iters), num_mc_samples=int(num_mc_samples),
        minimum_spike_count=int(minimum_spike_count),
        delay_spont_est=int(delay_spont_est), msrmp=float(msrmp),
        scale_factor=float(scale_factor), penalty=float(penalty),
        max_backtrack_iters=int(max_backtrack_iters), tol=float(tol),
        spont_orthogonality=float(spont_orthogonality),
        analytic_mc=bool(analytic_mc), save_histories=False,
        sweep_block_size=block, update_order=update_order)
    with span("cm.many.loop"):
        if mode == "sequential":
            finals = [_run_caviar(
                ys[b], stim_dev[b], lam0[b], lam_masks[b], powers_t,
                counts[b], hyper, [gens[b]],
                k_true=None if kts is None else kts[b], **loop)[0]
                for b in range(B)]
            final = [torch.stack(xs) for xs in zip(*finals)]
        elif mesh is None:
            final = _run_caviar(ys, stim_dev, lam0, lam_masks, powers_t,
                                counts, hyper, gens, k_true=kts, **loop)[0]
        else:
            final = _mesh_chunks(mesh, B, lambda ix, d: _run_caviar(
                *_on(d, ys[ix], stim_dev[ix], lam0[ix], lam_masks[ix],
                     powers_t, counts[ix]), _on(d, *hyper),
                [seeded_generator(seeds[b], d) for b in ix.tolist()],
                k_true=None if kts is None else kts[ix].to(d), **loop)[0])

    with span("cm.many.scan"):
        results, reconnected = [], []
        for b in range(B):
            kb = K if k_trues is None else int(k_trues[b])
            res = {name: v[b] for name, v in zip(FIELDS, final)}
            res["lam"], res["z"] = res["lam"][:, :kb], res["z"][:kb]
            if fn_scan:
                res["mu"], res["beta"], res["lam"], res["z"], n_rec = (
                    _reconnect_scan_device(
                        stim_dev[b, :, :kb], res["lam"], res["mu"],
                        res["beta"], res["z"], powers_t, float(msrmp),
                        float(minimum_spike_count)))
                if n_rec:
                    reconnected.append(b)
            results.append(res)
        if reconnected:
            # one refit for every changed experiment; a ragged stack pads
            # lam back to K and counts each experiment's own trials
            lam_sel = torch.zeros((len(reconnected), *final[2].shape[1:]),
                                  dtype=dtype, device=dev)
            for j, b in enumerate(reconnected):
                lam_sel[j, :, :results[b]["lam"].shape[1]] = \
                    results[b]["lam"]
            phi, phi_cov = laplace_phi_update(
                lam_sel, stim_dev[reconnected], hyper[4], hyper[5],
                powers=powers_t,
                total_trials=None if kts is None else kts[reconnected])
            for j, b in enumerate(reconnected):
                results[b]["phi"] = phi[j]
                results[b]["phi_cov"] = phi_cov[j]
    with span("cm.many.pull"):
        return [to_host(res) for res in results]


def _ragged_sequential_guard(name, mesh, compile_mode, powers):
    """Ragged SnS and MBCS stacks run each experiment's single fit at
    its true shape (the sequential mode); the knobs of one shared
    program raise, as in the JAX package."""
    if mesh is not None or compile_mode == "batched":
        raise ValueError(
            f"ragged {name} runs per-experiment sequential fits; "
            "mesh=/compile_mode='batched' need a same-shape stack, or "
            "caviar_many, whose k_trues supports both")
    if powers is not None:
        raise ValueError(
            f"ragged {name} scans each experiment's own stim levels; "
            "powers= applies only to same-shape stacks")


def _float_device(device, dtype, mesh=None):
    dev = _fit_device(mesh, device)
    return dev, torch_dtype(dtype)


def _split(finals, fields):
    """Per-experiment dicts of numpy arrays from a stacked final state."""
    host = to_host(dict(zip(fields, finals)))
    return [{f: host[f][b] for f in fields}
            for b in range(len(next(iter(host.values()))))]


SNS_FIELDS = ("mu", "beta", "alpha", "lam", "shape", "rate", "phi",
              "phi_cov")
MBCS_FIELDS = ("mu", "beta", "lam", "shape", "rate", "z", "receptive_fields")


def sns_many(
    y_pscs, stims, mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
    phi_prior, phi_cov_prior, iters=50, seeds=None, num_mc_samples=100,
    minimum_spike_count=3, analytic_mc=False, laplace_impl="auto",
    dtype=torch.float32, mesh=None, powers=None, compile_mode="auto",
    trace_wire=None, verbose=True, update_order="random", device=None,
):
    """Fit B experiments with CAVI-SnS; the signature of
    ``circuitmap_tpu.solvers.sns_many`` plus ``update_order`` (as
    ``cavi_sns``) and ``device`` (None means CUDA; the package's device
    rule). Priors are shared. Returns a list of B dicts of numpy arrays
    with keys mu/beta/alpha/lam/shape/rate/phi/phi_cov.

    ``compile_mode``: "sequential" ("auto" without a mesh) runs the single fit's
    loop per experiment; "batched" one loop over the stack, whose lam
    sweep is one launch of the batched row kernel and whose refit one
    Laplace launch an iteration. Experiment b draws its row orders and
    Monte Carlo samples from a generator seeded with ``seeds[b]``
    (default b), in the sequence of ``cavi_sns(seed=seeds[b])``, so the
    two modes agree to float rounding.

    A ragged list of [K_b, T] traces with matching [N, K_b] stims runs
    each experiment's single ``cavi_sns`` fit at its true shape.
    """
    from .cavi_sns import _run_sns, cavi_sns

    ragged_in = _ragged_lists(y_pscs, stims, "sns_many")
    if ragged_in is not None:
        _ragged_sequential_guard("sns_many", mesh, compile_mode, powers)
    dev, dtype = _float_device(device, dtype, mesh)
    resolve_laplace_impl(laplace_impl)
    if ragged_in is not None:
        ys_list, st_list, ks = ragged_in
        seeds = np.arange(len(ys_list)) if seeds is None else seeds
        if verbose:
            print(f"Running CAVI-SnS (PyTorch) on {len(ys_list)} "
                  f"experiments (ragged trials {min(ks)}-{max(ks)}, "
                  "sequential true-shape fits).")
        return [to_host(dict(zip(SNS_FIELDS, cavi_sns(
            yb, sb, mu_prior, beta_prior, alpha_prior, shape_prior,
            rate_prior, phi_prior, phi_cov_prior, iters=iters,
            num_mc_samples=num_mc_samples, seed=int(seeds[b]),
            minimum_spike_count=minimum_spike_count,
            analytic_mc=analytic_mc, laplace_impl=laplace_impl, dtype=dtype,
            trace_wire=trace_wire, save_histories=False,
            update_order=update_order, verbose=False, device=dev)[:8])))
            for b, (yb, sb) in enumerate(zip(ys_list, st_list))]

    y_pscs, stims_np = _same_shape_stack(y_pscs, stims, trace_wire, dtype)
    B, K, _T = y_pscs.shape
    if mesh is None:  # a mesh's per-device share is its own business
        warn_single_chip_envelope(
            B * stims_np.shape[1], K,
            what=f"sns_many() over {B} experiments", dtype=dtype,
            device=dev)
    mode = _resolve_mode(compile_mode, mesh)
    powers_np = _validate_shared_levels(stims_np, powers)
    if verbose:
        print(f"Running CAVI-SnS (PyTorch) on {B} experiments "
              f"(compile_mode={mode}).")
    y_dev = _upload_trace_stack(y_pscs, dtype, trace_wire, dev)
    stim_dev, powers_dev_np = _upload_stim_stack(stims_np, dtype, powers_np,
                                                 dev)
    ys = integrated_charge(y_dev)
    # the reference disables the activity mask for this solver
    masks = torch.ones((B, K), dtype=dtype, device=dev)
    lam0 = (stim_dev > 0).to(dtype) * 0.95
    powers_t = _as(powers_dev_np, dtype, dev)
    hyper = tuple(_as(a, dtype, dev) for a in (
        mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
        phi_prior, phi_cov_prior))
    seeds = np.arange(B) if seeds is None else seeds
    gens = [seeded_generator(sd, dev) for sd in seeds]
    loop = dict(iters=int(iters), num_mc_samples=int(num_mc_samples),
                minimum_spike_count=int(minimum_spike_count),
                analytic_mc=bool(analytic_mc), save_histories=False,
                update_order=_validate_update_order(str(update_order)))
    if mode == "sequential":
        finals = [_run_sns(ys[b], stim_dev[b], lam0[b], masks[b], powers_t,
                           hyper, [gens[b]], **loop)[0] for b in range(B)]
        final = [torch.stack(xs) for xs in zip(*finals)]
    elif mesh is None:
        final = _run_sns(ys, stim_dev, lam0, masks, powers_t, hyper, gens,
                         **loop)[0]
    else:
        final = _mesh_chunks(mesh, B, lambda ix, d: _run_sns(
            *_on(d, ys[ix], stim_dev[ix], lam0[ix], masks[ix], powers_t),
            _on(d, *hyper), [seeded_generator(seeds[b], d)
                             for b in ix.tolist()], **loop)[0])
    return _split(final, SNS_FIELDS)


def _mbcs_mask_init(y_psc, stim, y_xcorr_thresh, lam_mask_fraction,
                    init_spike_prior):
    """MBCS's activity masks [B, K] and lam inits [B, N, K] of a stack of
    [B, K, T] traces, on the traces' device: the energy threshold, and
    no trial whose peak is below ``lam_mask_fraction`` of its
    experiment's largest sample (the single fit's host rule)."""
    energy = torch.sum(y_psc * y_psc, dim=-1)
    mask = (energy > y_xcorr_thresh).to(y_psc.dtype)
    peaks = torch.amax(y_psc, dim=-1)
    top = torch.amax(y_psc, dim=(-2, -1))
    mask = torch.where(peaks < lam_mask_fraction * top[:, None], 0.0, mask)
    lam0 = (stim > 0).to(y_psc.dtype) * float(init_spike_prior) \
        * mask[:, None, :]
    return mask, lam0


def mbcs_many(
    y_pscs, stims, mu_prior, beta_prior, shape_prior, rate_prior, iters=50,
    seeds=None, penalty=5e0, scale_factor=0.5, max_penalty_iters=10,
    max_lasso_iters=100, constrain_weights="positive", learn_lam=True,
    delay_spont_estimation=1, minimum_spike_count=1, noise_scale=0.5,
    num_mc_samples_noise_model=10, minimum_maximal_spike_prob=0.2,
    orthogonal_outliers=True, outlier_penalty=5e1, init_spike_prior=0.75,
    outlier_tol=0.05, spont_rate=0, y_xcorr_thresh=0.05,
    lam_mask_fraction=0.05, analytic_noise=False, dtype=torch.float32,
    mesh=None, powers=None, compile_mode="auto", trace_wire=None,
    verbose=True, device=None,
):
    """Fit B experiments with MBCS; the signature of
    ``circuitmap_tpu.solvers.mbcs_many`` plus ``device`` (None means
    CUDA; the package's device rule). Priors are shared; experiment b's
    initial weights are the single fit's lognormal draw from
    ``np.random.default_rng(seeds[b])`` (default b), its row orders and
    noise samples come from a generator seeded with ``seeds[b]``.
    Returns a list of B dicts of numpy arrays with keys
    mu/beta/lam/shape/rate/z/receptive_fields.

    The activity masks are computed on the device (:func:`_mbcs_mask_init`).
    ``compile_mode``: "sequential" ("auto" without a mesh) runs the single fit's
    loop per experiment; "batched" one loop over the stack (FISTA over
    [B, N, N] with a stopping flag per experiment; the spike sweep over
    the union of the experiments' connected rows, each row kept only
    where its experiment's weight is nonzero). The modes agree to float
    rounding. Feed demixed traces, as ``mbcs`` documents.

    A ragged list runs each experiment's single ``mbcs`` fit at its true
    shape (host traces on the exact wire: ``trace_wire`` raises).
    """
    from .mbcs import _run_mbcs, fit_params, mbcs as mbcs_single

    ragged_in = _ragged_lists(y_pscs, stims, "mbcs_many")
    if ragged_in is not None:
        _ragged_sequential_guard("mbcs_many", mesh, compile_mode, powers)
    dev, dtype = _float_device(device, dtype, mesh)
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
    if ragged_in is not None:
        if trace_wire is not None:
            raise ValueError(
                "ragged mbcs_many has no trace_wire path (the single fit "
                "computes its activity mask from the host traces); ship "
                "float32, or use caviar_many for a compressed ragged wire")
        ys_list, st_list, ks = ragged_in
        seeds = np.arange(len(ys_list)) if seeds is None else seeds
        if verbose:
            print(f"Running MBCS (PyTorch) on {len(ys_list)} experiments "
                  f"(ragged trials {min(ks)}-{max(ks)}, sequential "
                  "true-shape fits).")
        single = dict(params, init_spike_prior=init_spike_prior,
                      spont_rate=spont_rate, y_xcorr_thresh=y_xcorr_thresh,
                      lam_mask_fraction=lam_mask_fraction)
        return [to_host(dict(zip(MBCS_FIELDS, mbcs_single(
            yb, sb, mu_prior, beta_prior, shape_prior, rate_prior,
            iters=iters, seed=int(seeds[b]), dtype=dtype,
            save_histories=False, verbose=False, device=dev,
            **single)[:7])))
            for b, (yb, sb) in enumerate(zip(ys_list, st_list))]

    y_pscs, stims_np = _same_shape_stack(y_pscs, stims, trace_wire, dtype)
    B, K, _T = y_pscs.shape
    if mesh is None:  # a mesh's per-device share is its own business
        warn_single_chip_envelope(
            B * stims_np.shape[1], K,
            what=f"mbcs_many() over {B} experiments", dtype=dtype,
            device=dev)
    N = np.asarray(mu_prior).shape[0]
    mode = _resolve_mode(compile_mode, mesh)
    powers_np = _validate_shared_levels(stims_np, powers)
    if verbose:
        print(f"Running MBCS (PyTorch) on {B} experiments "
              f"(compile_mode={mode}).")
    y_dev = _upload_trace_stack(y_pscs, dtype, trace_wire, dev)
    stim_dev, powers_dev_np = _upload_stim_stack(stims_np, dtype, powers_np,
                                                 dev)
    ys = integrated_charge(y_dev)
    masks, lam0 = _mbcs_mask_init(y_dev, stim_dev, float(y_xcorr_thresh),
                                  float(lam_mask_fraction), init_spike_prior)
    powers_with_zero = _as(np.concatenate([[0.0], powers_dev_np]), dtype, dev)
    seeds = np.arange(B) if seeds is None else seeds
    mu0 = _as(np.stack([np.random.default_rng(int(sd)).lognormal(1.0, 1.0, N)
                        for sd in seeds]), dtype, dev)
    beta_p = _as(beta_prior, dtype, dev)
    gens = [seeded_generator(sd, dev) for sd in seeds]
    shape0 = torch.full((B, K), float(shape_prior), dtype=dtype, device=dev)
    rate0 = torch.full((B, K), float(rate_prior), dtype=dtype, device=dev)
    spont0 = torch.full((B,), float(spont_rate), dtype=dtype, device=dev)
    loop = dict(iters=int(iters), save_histories=False)
    if mode == "sequential":
        outs = [_run_mbcs(ys[b], stim_dev[b], lam0[b], masks[b],
                          powers_with_zero, mu0[b], beta_p, shape0[b],
                          rate0[b], spont0[b], [gens[b]], params, **loop)
                for b in range(B)]
        final = [torch.stack(xs) for xs in zip(
            *[(*carry[:6], rf) for carry, rf, _ in outs])]
    elif mesh is None:
        carry, rf, _ = _run_mbcs(ys, stim_dev, lam0, masks, powers_with_zero,
                                 mu0, beta_p, shape0, rate0, spont0, gens,
                                 params, **loop)
        final = [*carry[:6], rf]
    else:
        def chunk(ix, d):
            carry, rf, _ = _run_mbcs(
                *_on(d, ys[ix], stim_dev[ix], lam0[ix], masks[ix],
                     powers_with_zero, mu0[ix], beta_p, shape0[ix],
                     rate0[ix], spont0[ix]),
                [seeded_generator(seeds[b], d) for b in ix.tolist()],
                params, **loop)
            return [*carry[:6], rf]
        final = _mesh_chunks(mesh, B, chunk)
    return _split(final, MBCS_FIELDS)
