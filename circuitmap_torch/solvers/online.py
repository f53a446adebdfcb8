"""Streaming CAVIaR: the posterior updates as trials arrive (port of
``circuitmap_tpu/solvers/online.py``).

``OnlineCaviar`` keeps the CAVI state on the fit's device in capacity
buffers and warm-starts more iterations each time a block of trials
arrives, so that a closed-loop experiment can read the posterior during
acquisition (``design.py``).

* **Capacity buffers.** Trials live in ``[N, C]`` tensors with ``C >=
  K``; the columns past the true count are inert (zero traces, masks,
  stim and spikes), and the fit counts trials from the true count
  (``_run_caviar``'s ``k_true``). The capacity is a multiple of 4 (the
  cluster sweep's column quads) and doubles when a block does not fit,
  so a stream of B blocks allocates O(log B) times.
* **Meshes.** With ``mesh`` (a ``parallel.TrialMesh``) the capacity is
  also a multiple of the shard count, the buffers and lam/z are kept as
  per-shard lists of the trial axis, and each update runs the
  trial-sharded loop (``parallel.sharded.run_sharded``); a block's
  insertion, a growth and the reconnection scan work on the gathered
  tensors and split them again.
* **Warm starts.** Each update resumes from the current state, numbers
  its iterations from the stream's running count (gate delays behave as
  in one long fit) and continues the stream's one ``torch.Generator``.
  The spontaneous update's seed is capped at ``max_backtrack_iters - 1``
  (``spont_seed_cap``): with the raw running count it would run no
  shrink step once the stream passed that many iterations, and the
  trials of every later block would get no spontaneous estimate.
* **Updates are transactions.** A block is written into new tensors
  (never in place) and the stream's state, counters and generator are
  replaced only after the fit and the reconnection scan succeed; an
  update that raises leaves the stream as it was (a grown capacity
  stays: it holds the same trials).

A single ``update`` over all trials, with fewer cumulative iterations
than ``max_backtrack_iters``, is the batch ``caviar()`` fit. With
``fn_scan=True`` (the default) every update ends with the reconnection
scan, which warm-started CAVI on thin early data needs (the JAX
module's docstring: a half-and-half stream plateaus at weight R² 0.42
without it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..ops.charge import prepare_observations
from ..utils.checkpoint import (GENERATOR_KEY, generator_state, load_state,
                                restore_generator, save_state)
from ._common import _bucketise_dense, _levels, prepare_traces
from ._laplace import resolve_laplace_impl
from .caviar import (CaviarState, _as, _reconnect_and_refit, _resolve_sweep,
                     _run_caviar, _validate_update_order, power_counts_of,
                     seeded_generator)

ALIGN = 4  # capacity granule: the cluster sweep's column quads


def _insert_block(bufs, levels, y_blk, bucket_blk, active_blk, k0):
    """New (y, stim, mask, lam) capacity tensors with one block of
    trials written at column ``k0``: the block's stim rebuilt from its
    int8 power buckets, its lam 0.95 on targeted active trials
    (reference caviar.py:32-34). The old tensors are left as they
    were."""
    y, stim, mask, lam = bufs
    kb = y_blk.shape[0]
    stim_blk = levels[bucket_blk.long()]
    act = active_blk.to(y.dtype)
    lam_blk = (stim_blk > 0).to(y.dtype) * 0.95 * act

    def put(buf, blk):
        out = buf.clone()
        out[..., k0:k0 + kb] = blk
        return out

    return (put(y, y_blk.to(y.dtype)), put(stim, stim_blk), put(mask, act),
            put(lam, lam_blk))


def _grow(a, pad):
    """``a`` with ``pad`` inert (zero) trial columns appended."""
    return torch.cat([a, a.new_zeros((*a.shape[:-1], pad))], dim=-1)


class OnlineCaviar:
    """Streaming CAVIaR over trial blocks (see the module docstring);
    the constructor of ``circuitmap_tpu.solvers.OnlineCaviar`` plus
    ``device`` (None means CUDA; the package's device rule).

    ``priors`` is the Model facade's prior dict (the reference defaults
    when omitted). ``powers`` should be the rig's stimulation levels;
    when omitted the level table comes from the first block, and a later
    block with an unseen level raises. ``mesh`` shards the stream's
    trials over a ``parallel.TrialMesh`` (``device`` is then the mesh's
    first device; see the module docstring).

    Usage::

        oc = OnlineCaviar(N, powers=[45., 55., 65.], device="cuda")
        for psc_blk, stim_blk in acquisition:      # demixed traces
            oc.update(psc_blk, stim_blk, iters=10)
            mu = oc.posterior()["mu"]
        final = oc.result()                        # with the fn-scan
    """

    def __init__(self, N, priors=None, powers=None, dtype=torch.float32,
                 seed=0, capacity=1024, y_xcorr_thresh=1e-2, msrmp=0.3,
                 num_mc_samples=100, minimum_spike_count=3,
                 delay_spont_est=1, scale_factor=0.75, penalty=5e0,
                 max_backtrack_iters=20, tol=0.05, spont_orthogonality=0.1,
                 analytic_mc=False, sweep_impl="auto",
                 sweep_block_size="auto", laplace_impl="auto",
                 update_order="random", mesh=None, device=None):
        self.mesh = mesh
        self._granule = ALIGN
        if mesh is None:
            self.device = resolve_device(device)
        else:
            from ..parallel.sharded import _require_local

            _require_local(mesh, "OnlineCaviar(mesh=)")
            self.device = mesh.devices[0]
            self._granule = math.lcm(ALIGN, mesh.n_local)
        self.dtype = torch_dtype(dtype)
        if priors is None:
            from ..model import default_priors

            priors = default_priors(N)
        self.N = int(N)
        self._priors = tuple(
            _as(priors[k], self.dtype, self.device)
            for k in ("mu", "beta", "shape", "rate", "phi", "phi_cov"))
        self._y_xcorr_thresh = float(y_xcorr_thresh)
        self._msrmp = float(msrmp)
        self._min_spike_count = int(minimum_spike_count)
        resolve_laplace_impl(laplace_impl)
        self._loop = dict(
            num_mc_samples=int(num_mc_samples),
            minimum_spike_count=int(minimum_spike_count),
            delay_spont_est=int(delay_spont_est), msrmp=float(msrmp),
            scale_factor=float(scale_factor), penalty=float(penalty),
            max_backtrack_iters=int(max_backtrack_iters), tol=float(tol),
            spont_orthogonality=float(spont_orthogonality),
            analytic_mc=bool(analytic_mc), save_histories=False,
            sweep_block_size=_resolve_sweep(sweep_impl, sweep_block_size,
                                            self.device),
            update_order=_validate_update_order(str(update_order)),
            spont_seed_cap=int(max_backtrack_iters) - 1)
        self._generator = seeded_generator(seed, self.device)

        # the level table: fixed by powers= now, or by the first block
        self._powers_np = self._levels_np = self._levels_t = None
        if powers is not None:
            self._set_levels(*_levels(np.zeros((1, 1)), powers))

        self.k = 0               # true trials seen
        self.it = 0              # CAVI iterations run
        self._n_reconnected = 0  # by the latest update's fn-scan
        self._C = self._ceil(max(int(capacity), ALIGN))
        self._bufs = None        # (y, stim, mask) at capacity
        self._state = None       # CaviarState at capacity

    # -- internals ---------------------------------------------------------

    def _set_levels(self, powers_np, levels_np):
        self._powers_np, self._levels_np = powers_np, levels_np
        self._levels_t = (None if levels_np is None else
                          _as(levels_np, self.dtype, self.device))

    def _ceil(self, n):
        return -(-int(n) // self._granule) * self._granule

    def _full(self, a):
        """A trial-axis tensor whole: a mesh's per-shard list gathered on
        the first device."""
        return self.mesh.gather(a) if isinstance(a, list) else a

    def _part(self, a):
        """A trial-axis tensor as kept between updates: split over the
        mesh's shards, or whole without a mesh."""
        return a if self.mesh is None else self.mesh.split(a)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _ensure_capacity(self, k_needed):
        """Grow the buffers (by doubling) to hold ``k_needed`` trials."""
        if k_needed <= self._C:
            return
        new_c = self._ceil(max(2 * self._C, k_needed))
        if self._bufs is not None:
            pad = new_c - self._C

            def grow(a):
                return self._part(_grow(self._full(a), pad))
            self._bufs = tuple(grow(a) for a in self._bufs)
            self._state = self._state._replace(
                lam=grow(self._state.lam), z=grow(self._state.z))
        self._C = new_c

    # -- streaming API -----------------------------------------------------

    def update(self, psc_block, stim_block, iters=10, fn_scan=True,
               trace_wire=None):
        """Ingest a block of trials and run ``iters`` more CAVI
        iterations warm-started from the current posterior.

        ``psc_block``: [k_b, T] demixed traces (a host array, or a
        tensor, which is moved to the stream's device as it is);
        ``stim_block``: [N, k_b] the stimuli of those trials.
        ``trace_wire`` compresses a host block's trace upload as the
        batch solvers do (``_common.prepare_traces``). ``fn_scan=True`` runs the
        reconnection scan (and the refit it may need) after the
        iterations, into the streaming state. Returns self.
        """
        if int(iters) < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        psc = (psc_block if isinstance(psc_block, torch.Tensor)
               else np.asarray(psc_block))
        if psc.ndim == 1:
            psc = psc[None]
        stim_np = np.asarray(stim_block)
        if stim_np.ndim == 1:
            stim_np = stim_np[:, None]
        if stim_np.shape[0] != self.N:
            raise ValueError(
                f"stim_block has {stim_np.shape[0]} neurons, model has "
                f"{self.N}")
        kb = psc.shape[0]
        if kb == 0:
            raise ValueError("empty trial block")
        if stim_np.shape[1] != kb:
            raise ValueError(
                f"psc_block carries {kb} trials but stim_block "
                f"{stim_np.shape[1]}")

        fresh_table = self._levels_np is None
        if fresh_table:
            powers_np, levels_np = _levels(stim_np, None)
            if levels_np.size < 2:
                raise ValueError(
                    "the first block carries no nonzero stimulation, so "
                    "no power-level table can be derived from it; pass "
                    "powers= up front")
            self._set_levels(powers_np, levels_np)
        rng_state = self._generator.get_state()
        try:
            return self._update_guarded(psc, stim_np, kb, int(iters),
                                        fn_scan, trace_wire)
        except BaseException:
            # the stream stays as it was: its random stream too, and a
            # failed first update leaves no level table behind
            self._generator.set_state(rng_state)
            if fresh_table:
                self._set_levels(None, None)
            raise

    def _update_guarded(self, psc, stim_np, kb, iters, fn_scan, trace_wire):
        """``update()``'s body after validation; everything is staged in
        locals and committed to self only at the end."""
        bucket = torch.from_numpy(_bucketise_dense(stim_np, self._levels_np))
        self._ensure_capacity(self.k + kb)
        if self._bufs is None:
            self._bufs = tuple(self._part(a) for a in (
                self._zeros(self._C), self._zeros(self.N, self._C),
                self._zeros(self._C)))
        traces = prepare_traces(psc, self.dtype, self.device,
                                trace_wire=trace_wire)
        y_blk, active_blk = prepare_observations(traces,
                                                 self._y_xcorr_thresh)
        lam = (self._zeros(self.N, self._C) if self._state is None
               else self._full(self._state.lam))
        y, stim, mask, lam = _insert_block(
            (*(self._full(b) for b in self._bufs), lam), self._levels_t,
            y_blk, bucket.to(self.device), active_blk, self.k)
        if self._state is None:
            mu_p, beta_p, shape_p, rate_p, phi_p, phi_cov_p = self._priors
            state = CaviarState(mu_p, beta_p, lam, shape_p, rate_p,
                                phi_p.expand(self.N, 2),
                                phi_cov_p.expand(self.N, 2, 2),
                                self._zeros(self._C), self._zeros())
        else:
            state = self._state._replace(lam=lam, z=self._full(self._state.z))
        k_new = self.k + kb
        powers = self._levels_t[1:]
        if self.mesh is None:
            state = _run_caviar(
                y, stim, None, mask, powers,
                power_counts_of(stim, powers, self.dtype), self._priors,
                [self._generator], iters=iters, start_iter=self.it,
                init_state=state, k_true=k_new, **self._loop)[0]
        else:
            state = self._run_sharded(y, stim, mask, powers, state, k_new,
                                      iters)
        n_rec = self._n_reconnected
        if fn_scan:
            mu, beta, lam, z, phi, phi_cov, n_rec = self._reconnect(
                state, stim, k_new)
            state = state._replace(mu=mu, beta=beta, lam=lam, z=z, phi=phi,
                                   phi_cov=phi_cov)
        # commit: the fit and the scan succeeded, the block is in
        self._bufs = tuple(self._part(a) for a in (y, stim, mask))
        self._state = state._replace(lam=self._part(state.lam),
                                     z=self._part(state.z))
        self.k = k_new
        self.it += iters
        self._n_reconnected = n_rec
        return self

    def _run_sharded(self, y, stim, mask, powers, state, k_new, iters):
        """``iters`` iterations of the trial-sharded loop from the whole
        ``state``; returns the whole state."""
        from ..parallel.sharded import run_sharded, shard_tensors

        mesh = self.mesh
        st = CaviarState(*(
            mesh.split(v) if f in ("lam", "z") else mesh.replicate(v)
            for f, v in state._asdict().items()))
        st = run_sharded(
            mesh, shard_tensors(mesh, y, stim, mask, k_new, powers),
            tuple(mesh.replicate(p) for p in self._priors), self._generator,
            iters=iters, start_iter=self.it, init_state=st, **self._loop)[0]
        return CaviarState(*(mesh.gather(v) if f in ("lam", "z") else v[0]
                             for f, v in st._asdict().items()))

    def _reconnect(self, state, stim, k):
        state = state._replace(lam=self._full(state.lam),
                               z=self._full(state.z))
        return _reconnect_and_refit(
            self._full(stim), state.lam, state.mu, state.beta, state.z,
            self._levels_t[1:], state.phi, state.phi_cov, self._priors[4],
            self._priors[5], self._msrmp, float(self._min_spike_count),
            total_trials=k)

    @property
    def trial_count(self):
        return self.k

    @property
    def iteration(self):
        return self.it

    @property
    def last_reconnected(self):
        """Connections the latest update's fn-scan restored."""
        return int(self._n_reconnected)

    def posterior(self):
        """The small fields as numpy (no [N, K] pull): mu, beta, phi,
        phi_cov, shape, rate, spont_rate."""
        self._require_state()
        s = self._state
        return {f: getattr(s, f).cpu().numpy() for f in (
            "mu", "beta", "phi", "phi_cov", "shape", "rate", "spont_rate")}

    def result(self, fn_scan=True):
        """The full posterior at the true trial count as numpy, after the
        reconnection scan with ``fn_scan``. Non-destructive: the stream
        is left as it was, so acquisition can go on after a readout."""
        self._require_state()
        s = self._state
        mu, beta, lam, z, phi, phi_cov = (s.mu, s.beta, self._full(s.lam),
                                          self._full(s.z), s.phi, s.phi_cov)
        n_rec = 0
        if fn_scan:
            mu, beta, lam, z, phi, phi_cov, n_rec = self._reconnect(
                s, self._bufs[1], self.k)
        k = self.k
        out = dict(mu=mu, beta=beta, lam=lam[:, :k], z=z[:k], shape=s.shape,
                   rate=s.rate, phi=phi, phi_cov=phi_cov,
                   spont_rate=s.spont_rate)
        out = {name: v.cpu().numpy() for name, v in out.items()}
        return dict(out, n_reconnected=int(n_rec), trial_count=k,
                    iterations=self.it)

    def _require_state(self):
        if self._state is None:
            raise RuntimeError(
                "no trials ingested yet — call update() first")

    # -- crash recovery ------------------------------------------------------

    def save(self, path):
        """Checkpoint the whole stream (atomic write): the capacity
        buffers, the CAVI state, the level table, the counters and the
        random stream. ``load`` restores a stream that continues exactly
        where this one stopped (pass it the same fit options: they are
        configuration, not state)."""
        self._require_state()
        y, stim, mask = (self._full(b) for b in self._bufs)
        save_state(path, {
            "k": np.asarray(self.k), "it": np.asarray(self.it),
            "levels": self._levels_np, "powers_host": self._powers_np,
            "y": y, "stim": stim, "mask": mask,
            "state": {f: self._full(v)
                      for f, v in self._state._asdict().items()},
            GENERATOR_KEY: generator_state(self._generator)})

    @classmethod
    def load(cls, path, N=None, **kwargs):
        """Restore a stream that ``save`` checkpointed; ``kwargs`` are
        the constructor's fit options (those of the original stream). A
        checkpoint written by the JAX package raises: it holds a
        ``jax.random`` key, which the port's generator cannot
        continue."""
        ck = load_state(path)
        n = int(ck["stim"].shape[0])
        if N is not None and int(N) != n:
            raise ValueError(f"checkpoint carries N={n}, got N={N}")
        self = cls(n, **kwargs)
        restore_generator(self._generator, ck.get(GENERATOR_KEY), path)
        self._set_levels(np.asarray(ck["powers_host"]),
                         np.asarray(ck["levels"], np.float32))
        self.k = int(ck["k"])
        self.it = int(ck["it"])
        # a checkpoint's capacity may not divide this stream's mesh: grow
        # to the alignment (inert columns)
        c_ck = int(ck["stim"].shape[1])
        self._C = self._ceil(c_ck)
        dt, dev = self.dtype, self.device

        def load(a):
            return self._part(_grow(_as(a, dt, dev), self._C - c_ck))
        self._bufs = tuple(load(ck[f]) for f in ("y", "stim", "mask"))
        st = ck["state"]
        self._state = CaviarState(**{
            f: load(st[f]) if f in ("lam", "z") else _as(st[f], dt, dev)
            for f in CaviarState._fields})
        return self
