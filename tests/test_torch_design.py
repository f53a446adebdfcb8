"""The port's closed-loop design (``circuitmap_torch.design``) against the
JAX package's.

The design policy is host numpy in both packages, drawing from numpy's
global random state: given the same state and the same numpy inputs,
``pool_design`` and ``AdaptiveDesigner`` give identical designs, pools
and counts (exact). The checkpoints share one format, so either package
restores the other's designer. ``closed_loop_map`` runs a small
simulated experiment through the port's ``OnlineCaviar`` on the CPU.
"""

import numpy as np
import pytest
import torch

import circuitmap_tpu.design as jd
import circuitmap_torch as cm
import circuitmap_torch.design as td
from circuitmap_torch.utils.metrics import r2_score

POWERS = [45.0, 55.0, 65.0]


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs: the suite
    runs in parallel workers, and a pool of threads per worker
    oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("pool,N,H,trials", [
    (np.arange(5, 35), 100, 5, 60),        # a large pool: whole holograms
    (np.array([3, 7]), 30, 6, 45),         # a small pool with fillers
    (np.arange(12), 12, 4, 30),            # no neuron outside the pool
    (np.array([0, 9, 17, 25, 38]), 40, 3, 90),
])
def test_pool_design_matches_jax(pool, N, H, trials):
    np.random.seed(4)
    want = jd.pool_design(pool, N, H, trials, POWERS)
    np.random.seed(4)
    got = td.pool_design(pool, N, H, trials, POWERS)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (N, trials)


def test_pool_design_validation():
    for bad in (np.array([], int), np.array([[1]]), np.array([-1]),
                np.array([40])):
        with pytest.raises(ValueError):
            td.pool_design(bad, 40, 4, 10, POWERS)


def _posteriors(N, rounds, seed=0):
    """Synthetic detection calls that flicker between rounds."""
    rng = np.random.default_rng(seed)
    strong = rng.random(N) < 0.2
    return [{"mu": np.where(strong & (rng.random(N) < 0.8),
                            rng.uniform(5, 30, N), 0.0)}
            for _ in range(rounds)]


def test_adaptive_designer_matches_jax():
    N, H, trials = 40, 5, 60
    designers = (td.AdaptiveDesigner(N, H, POWERS, null_trials=6,
                                     conn_trials=12),
                 jd.AdaptiveDesigner(N, H, POWERS, null_trials=6,
                                     conn_trials=12))
    for post in _posteriors(N, 6):
        if designers[1].resolved:
            break
        stims = []
        for d in designers:
            np.random.seed(designers[1].rounds)
            stims.append(d.next_design(trials))
        np.testing.assert_array_equal(*stims)
        left = [d.observe(stims[0].astype(np.float32), post)
                for d in designers]
        assert left[0] == left[1]
        np.testing.assert_array_equal(designers[0].pool, designers[1].pool)
        np.testing.assert_array_equal(designers[0].maxpow_count,
                                      designers[1].maxpow_count)
    assert designers[0].rounds == designers[1].rounds >= 2
    assert designers[0].pool.size < N
    assert designers[0].resolved == designers[1].resolved


def test_designer_save_load_and_cross_package(tmp_path):
    d = td.AdaptiveDesigner(30, 4, POWERS, null_trials=5, conn_trials=9)
    np.random.seed(1)
    for post in _posteriors(30, 2, seed=3):
        d.observe(d.next_design(45), post)
    d.save(tmp_path / "port.npz")
    for restored in (td.AdaptiveDesigner.load(tmp_path / "port.npz"),
                     jd.AdaptiveDesigner.load(tmp_path / "port.npz")):
        assert (restored.N, restored.H, restored.rounds) == (30, 4, 2)
        assert (restored.null_trials, restored.conn_trials) == (5, 9)
        np.testing.assert_array_equal(restored.pool, d.pool)
        np.testing.assert_array_equal(restored.maxpow_count, d.maxpow_count)
        np.testing.assert_array_equal(restored.powers, d.powers)
    jd.AdaptiveDesigner.load(tmp_path / "port.npz").save(tmp_path / "jax.npz")
    back = td.AdaptiveDesigner.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(back.pool, d.pool)


def test_designer_validation():
    with pytest.raises(ValueError):
        td.AdaptiveDesigner(0, 2, POWERS)
    with pytest.raises(ValueError):
        td.AdaptiveDesigner(5, 2, [])
    with pytest.raises(ValueError):
        td.AdaptiveDesigner(5, 2, POWERS, null_trials=10, conn_trials=5)
    d = td.AdaptiveDesigner(5, 2, POWERS)
    with pytest.raises(ValueError):
        d.observe(np.zeros((4, 3)), {"mu": np.zeros(5)})
    with pytest.raises(ValueError):
        d.observe(np.zeros((5, 3)), {"mu": np.zeros(4)})


def test_closed_loop_map_on_the_cpu():
    """The loop narrows the pool, stops by itself or at max_rounds, and
    its streaming posterior recovers the circuit (the JAX test's 0.8)."""
    np.random.seed(3)
    N = 40
    pilot = cm.simulate(N=N, trials=120, H=5, connection_prob=0.1,
                        powers=POWERS, verbose=False, device="cpu")
    truth = {k: pilot[k] for k in
             ("weights", "phi_0", "phi_1", "tau_r", "tau_d")}

    def acquire(stim):
        return cm.simulate(
            N=N, stim_matrix=stim, weights=truth["weights"],
            phi_0=truth["phi_0"], phi_1=truth["phi_1"],
            kernel=(truth["tau_r"], truth["tau_d"]), powers=POWERS,
            verbose=False, device="cpu")["psc"]

    rounds_seen = []
    post, designer, solver = cm.closed_loop_map(
        acquire, N=N, H=5, powers=POWERS, block_trials=120, max_rounds=4,
        iters_per_round=8, device="cpu", dtype=torch.float64,
        callback=lambda r, d, p: rounds_seen.append((r, int(d.pool.size))))
    assert solver.device.type == "cpu" and solver.dtype == torch.float64
    assert designer.rounds == len(rounds_seen) >= 1
    assert solver.trial_count == 120 * designer.rounds
    pools = [p for _, p in rounds_seen]
    assert pools[-1] <= pools[0] <= N
    assert r2_score(truth["weights"], post["mu"]) > 0.8
    with pytest.raises(ValueError, match="online_kwargs"):
        cm.closed_loop_map(acquire, N=N, H=5, powers=POWERS,
                           block_trials=10, max_rounds=1, solver=solver,
                           dtype=torch.float64)
    with pytest.raises(ValueError, match="acquire returned"):
        cm.closed_loop_map(lambda s: np.zeros((3, 900)), N=N, H=5,
                           powers=POWERS, block_trials=10, max_rounds=1,
                           device="cpu")
