"""Closed-loop stimulus design: posterior-guided hologram selection
(port of ``circuitmap_tpu/design.py``).

After every acquisition block the streaming solver's interim posterior
(``solvers/online.py``) decides where the remaining trial budget goes,
and the experiment can end early once every neuron's status is
resolved.

Design policy (the JAX package's, validated in its
``examples/demo_closed_loop.py``):

- Neurons are "resolved" on evidence counts at max power: an undetected
  neuron is a resolved null after ``null_trials`` max-power
  stimulations without a connection call; a detected connection is
  resolved once ``conn_trials`` max-power stimulations have pinned its
  weight. A neuron detected in either of the last two readouts is held
  to the ``conn_trials`` bar, so a momentary gate dropout cannot demote
  a connection to the null budget.
- Each round's holograms are drawn blockwise over the unresolved pool,
  topped up with random resolved fillers; small varying pool subsets
  keep the design columns incoherent.

Everything here is host numpy (designs are small matrices; the
posterior snapshot is the streaming solver's small-field pull); the
demixing and the fits run on the solver's device.
"""

import numpy as np

from .simulation import blockwise_design

__all__ = ["pool_design", "AdaptiveDesigner", "closed_loop_map"]


def pool_design(pool, N, H, trials, powers):
    """Blockwise ensemble design concentrated on ``pool``.

    Builds a [N, trials] stimulus matrix whose holograms sweep the pool
    blockwise (every pool neuron is covered once per sweep at each
    power) and, when the pool is smaller than the hologram size, fills
    the remaining spots with random neurons from outside the pool so
    the optical dose per trial stays comparable to the static protocol.

    When the pool is still large (>= 3x the hologram size) the whole
    hologram is drawn from the pool; once it shrinks, holograms take at
    most H//2 pool neurons each — varying small subsets keep the design
    columns incoherent (see module docstring).
    """
    pool = np.asarray(pool, dtype=int)
    if pool.ndim != 1 or pool.size == 0:
        raise ValueError("pool must be a non-empty 1-D index array")
    if np.any(pool < 0) or np.any(pool >= N):
        raise ValueError("pool indices out of range")
    H = int(H)
    rest = np.setdiff1d(np.arange(N), pool)
    n_pool = (min(H, len(pool)) if len(pool) >= 3 * H or not len(rest)
              else min(len(pool), max(1, H // 2)))
    sub = blockwise_design(len(pool), n_pool, trials, powers)
    stim = np.zeros((N, trials))
    stim[pool] = sub
    n_fill = H - n_pool
    if n_fill > 0 and len(rest):
        n_fill = min(n_fill, len(rest))
        power = sub.max(axis=0)
        for k in np.flatnonzero(power > 0):
            stim[np.random.choice(rest, n_fill, replace=False), k] = power[k]
    return stim


class AdaptiveDesigner:
    """Evidence-count design policy over a shrinking candidate pool.

    Protocol per acquisition round::

        stim = designer.next_design(trials)     # where to stimulate
        psc  = <acquire trials with stim>        # rig / simulator
        solver.update(demixed_psc, stim, ...)    # OnlineCaviar
        designer.observe(stim, solver.posterior())

    ``resolved`` flips True once every neuron is either a pinned
    connection or an evidenced null — the experiment can stop there.
    """

    def __init__(self, N, H, powers, null_trials=18, conn_trials=30):
        self.N = int(N)
        self.H = int(H)
        if self.N <= 0 or self.H <= 0:
            raise ValueError("N and H must be positive")
        self.powers = np.sort(np.asarray(powers, dtype=float))
        if self.powers.size == 0 or np.any(self.powers <= 0):
            raise ValueError("powers must be positive stimulation levels")
        if not (0 < null_trials <= conn_trials):
            raise ValueError("need 0 < null_trials <= conn_trials")
        self.null_trials = int(null_trials)
        self.conn_trials = int(conn_trials)
        self.maxpow_count = np.zeros(self.N)
        self._prev_detected = np.zeros(self.N, dtype=bool)
        self._resolved = np.zeros(self.N, dtype=bool)
        self._pool = np.arange(self.N)
        self.rounds = 0

    @property
    def pool(self):
        """Indices of currently unresolved neurons (copy)."""
        return self._pool.copy()

    @property
    def resolved(self):
        """True once every neuron's status is evidence-resolved."""
        return self._pool.size == 0

    def next_design(self, trials):
        """[N, trials] stimulus for the next block.

        Round 0 is the static blockwise protocol over all neurons (no
        posterior exists yet); later rounds concentrate on the pool.
        """
        if self.resolved:
            raise ValueError(
                "all neurons resolved — the experiment is complete")
        if self.rounds == 0 or self._pool.size == self.N:
            return blockwise_design(self.N, self.H, trials, self.powers)
        return pool_design(self._pool, self.N, self.H, trials, self.powers)

    def observe(self, stim, posterior):
        """Fold one acquired block into the resolution state.

        ``stim``: the [N, trials] design actually stimulated.
        ``posterior``: mapping with key 'mu' (the online solver's
        ``posterior()`` snapshot) — mu != 0 is the detection call.
        Returns the number of still-unresolved neurons.
        """
        stim = np.asarray(stim)
        if stim.shape[0] != self.N:
            raise ValueError(
                f"stim has {stim.shape[0]} rows, designer built for N={self.N}")
        mu = np.asarray(posterior["mu"])
        if mu.shape != (self.N,):
            raise ValueError(f"posterior mu has shape {mu.shape}, want ({self.N},)")
        # tolerant match, not ==: the stim matrix may round-trip through
        # a narrower dtype between design and observe (rigs and clients
        # ship float32; 45.7 != float32(45.7) exactly),
        # and a missed match here silently freezes resolution forever
        self.maxpow_count += np.isclose(
            stim, self.powers.max(), rtol=1e-5, atol=0.0).sum(axis=1)
        detected = mu != 0
        ever_recent = detected | self._prev_detected
        unresolved = np.where(ever_recent,
                              self.maxpow_count < self.conn_trials,
                              self.maxpow_count < self.null_trials)
        # Resolution is STICKY: the pool only ever shrinks. Without
        # this, a neuron resolved as a null re-enters the pool if the
        # detection gate flickers on in a later round (ever_recent
        # raises its threshold to conn_trials), `resolved` can
        # oscillate back to False, and an experiment loop that stopped
        # designing on an earlier resolved=True would crash in
        # next_design. The cost is deliberate: a null that only shows
        # evidence AFTER its null_trials budget stays resolved — the
        # budget is the policy's detection deadline, not a lower bound.
        self._resolved |= ~unresolved
        self._pool = np.flatnonzero(~self._resolved)
        self._prev_detected = detected
        self.rounds += 1
        return int(self._pool.size)

    def save(self, path):
        """Checkpoint the policy state (atomic write) — small host
        arrays only. Pairs with ``OnlineCaviar.save`` so a crashed
        closed-loop experiment restores BOTH halves: the posterior
        stream and the design policy's evidence counts."""
        from .utils.checkpoint import save_state

        save_state(path, dict(
            N=np.asarray(self.N), H=np.asarray(self.H),
            powers=self.powers,
            null_trials=np.asarray(self.null_trials),
            conn_trials=np.asarray(self.conn_trials),
            maxpow_count=self.maxpow_count,
            prev_detected=self._prev_detected,
            resolved_mask=self._resolved,
            rounds=np.asarray(self.rounds),
        ))

    @classmethod
    def load(cls, path):
        """Restore a designer checkpointed by ``save`` (configuration
        AND evidence state — unlike ``OnlineCaviar.load``, nothing has
        to be re-supplied)."""
        from .utils.checkpoint import load_state

        ck = load_state(path)
        self = cls(int(ck["N"]), int(ck["H"]), np.asarray(ck["powers"]),
                   null_trials=int(ck["null_trials"]),
                   conn_trials=int(ck["conn_trials"]))
        self.maxpow_count = np.asarray(ck["maxpow_count"], dtype=float)
        self._prev_detected = np.asarray(ck["prev_detected"], dtype=bool)
        self._resolved = np.asarray(ck["resolved_mask"], dtype=bool)
        self._pool = np.flatnonzero(~self._resolved)
        self.rounds = int(ck["rounds"])
        return self


def closed_loop_map(acquire, N, H, powers, block_trials, max_rounds,
                    iters_per_round=8, designer=None, solver=None,
                    demixer=None, callback=None, device=None,
                    **online_kwargs):
    """Run a closed-loop mapping experiment; the signature of
    ``circuitmap_tpu.design.closed_loop_map`` plus ``device`` (the
    ``OnlineCaviar`` built here runs there; None means CUDA, the
    package's device rule).

    ``acquire(stim) -> psc``: the rig (or simulator) callback: given an
    [N, trials] design, return the recorded [trials, T] traces. Blocks
    stream through ``OnlineCaviar``; the ``AdaptiveDesigner`` narrows the
    stimulation pool each round, and the loop stops once every neuron is
    resolved (or after ``max_rounds``).

    ``demixer``: optional ``NeuralDemixer`` applied to each acquired
    block before the solver sees it (raw rig traces need it; simulator
    output is already clean). ``callback(round, designer, posterior)``:
    optional per-round hook.

    Returns ``(posterior, designer, solver)``: the final small-field
    posterior snapshot and both state objects.
    """
    from .solvers.online import OnlineCaviar

    if designer is None:
        designer = AdaptiveDesigner(N, H, powers)
    if solver is None:
        solver = OnlineCaviar(N, powers=list(np.sort(np.asarray(
            powers, dtype=float))), device=device, **online_kwargs)
    elif online_kwargs:
        raise ValueError("pass online_kwargs only when solver is None")
    post = None
    for r in range(int(max_rounds)):
        if designer.resolved:
            break
        stim = designer.next_design(block_trials)
        psc = np.asarray(acquire(stim))
        if psc.ndim != 2 or psc.shape[0] != stim.shape[1]:
            raise ValueError(
                f"acquire returned shape {psc.shape} for {stim.shape[1]} trials")
        if demixer is not None:
            psc = demixer(psc, verbose=False)
        solver.update(psc, stim, iters=iters_per_round)
        post = solver.posterior()
        designer.observe(stim, post)
        if callback is not None:
            callback(r, designer, post)
    return post, designer, solver
