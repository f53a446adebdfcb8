"""W1, the weight update's Gram from the design's co-stimulation lists
(``ops/gram_cuda.py``, ``csrc/gram_costim.cu``), and the invariant it
rests on: CAVIaR's spike posterior is zero wherever the stim is.

On any machine: the lists against numpy, a plain index_add Gram over
them against the dense product, the dispatch (W1 within the kernel's 96
targets a trial and the crossover measured against cuBLAS; the CPU and
a stack of experiments keep the dense product), the launch plan, the
wrapper's refusals and the invariant after CPU fits and a
reconnection. The tests marked ``cuda`` need an NVIDIA GPU and nvcc and
skip without one: W1 against ``lam @ lam.mT`` at both benchmark
configurations' shapes, its repeatability and symmetry, and the fits'
counts. This file imports neither JAX nor circuitmap_tpu, so on a
machine with the card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gram.py

Tolerances. W1 takes each element's products in ascending trial order,
one fused multiply-add each from 0; the float64 comparisons against the
dense product (another order) are held to 1e-12 of the largest entry.
"""

import importlib

import numpy as np
import pytest
import torch

from circuitmap_torch.model import default_priors
from circuitmap_torch.ops import gram_cuda
from circuitmap_torch.ops.gram_cuda import (costim_gram, costim_lists, gram,
                                            takes_w1)

cav = importlib.import_module("circuitmap_torch.solvers.caviar")

POWERS = (45.0, 55.0, 65.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _design(N, K, H, seed=0, full=False, silent=(3,)):
    """An [N, K] stim from hologram targets [H, K], -1 padded: each trial
    stimulates a random count in 0..H of distinct neurons (exactly H when
    ``full``), none of those in ``silent``. Returns (stim, targets)."""
    rng = np.random.default_rng(seed)
    pool = np.setdiff1d(np.arange(N), silent)
    targets = np.full((H, K), -1, np.int64)
    stim = np.zeros((N, K), np.float64)
    for k in range(K):
        h = H if full else rng.integers(0, H + 1)
        t = np.sort(rng.choice(pool, h, replace=False))
        targets[:h, k] = t
        stim[t, k] = rng.choice(POWERS, h)
    return stim, targets


def _posterior(stim, seed=1, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return np.where(stim > 0, rng.uniform(0, 1, stim.shape), 0).astype(dtype)


def _lists_numpy(stim, targets):
    """The lists from the hologram targets, in :class:`CostimLists`'
    order: by neuron its trials, ascending, and where each (neuron,
    trial) sits in the trials' order; by trial its targets, ascending,
    and each target's trial."""
    N, K = stim.shape
    by_trial = [np.sort(targets[:, k][targets[:, k] >= 0]) for k in range(K)]
    by_neuron = [np.flatnonzero(stim[i]) for i in range(N)]
    ptr = lambda lists: np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    cat = lambda lists: np.concatenate(lists + [np.zeros(0, np.int64)])
    trial_ptr = ptr(by_trial)
    pos = [[trial_ptr[k] + int(np.searchsorted(by_trial[k], i)) for k in ks]
           for i, ks in enumerate(by_neuron)]
    return (ptr(by_neuron), cat(by_neuron), cat([np.array(p, np.int64)
                                                 for p in pos]),
            trial_ptr, cat(by_trial),
            cat([np.full(len(t), k) for k, t in enumerate(by_trial)]))


def _index_add_gram(lam, lists):
    """Plain Gram over the lists: every co-stimulated pair (i, j) of a
    trial k adds lam[i, k] lam[j, k] into G[i, j]."""
    N, K = lam.shape
    tptr = lists.trial_ptr.long()
    h = tptr[1:] - tptr[:-1]                       # targets a trial
    trial_of = torch.repeat_interleave(torch.arange(K), h)   # a target's trial
    reps = h[trial_of]                             # pairs a target makes
    first = torch.repeat_interleave(torch.arange(trial_of.numel()), reps)
    start = torch.repeat_interleave(tptr[trial_of], reps)
    offset = torch.arange(first.numel()) - torch.repeat_interleave(
        torch.cumsum(reps, 0) - reps, reps)
    second = start + offset
    tg = lists.targets.long()
    i, j, k = tg[first], tg[second], trial_of[first]
    G = torch.zeros(N * N, dtype=lam.dtype)
    G.index_add_(0, i * N + j, lam[i, k] * lam[j, k])
    return G.reshape(N, N)


# ---------------------------------------------------------------------------
# The lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,K,H", [(40, 300, 1), (200, 600, 10),
                                   (300, 400, 96)])
def test_lists_match_numpy(N, K, H):
    stim, targets = _design(N, K, H)
    want = _lists_numpy(stim, targets)
    got = costim_lists(torch.from_numpy(stim), always=True)
    assert got.hmax == max(len(np.flatnonzero(stim[:, k])) for k in range(K))
    for g, w in zip(got[:6], want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    # the design has empty trials and a neuron never stimulated
    assert (np.diff(want[3]) == 0).any()
    assert want[0][4] == want[0][3]


def test_lists_are_built_where_the_rule_takes_them(monkeypatch):
    stim, _ = _design(100, 200, 7, full=True)
    seen = []

    def rule(N, K, hmax, row_trials, pairs, dtype):
        seen.append((N, K, hmax, row_trials, pairs, dtype))
        return hmax <= cap

    monkeypatch.setattr(gram_cuda, "takes_w1", rule)
    cap = 6
    assert costim_lists(torch.from_numpy(stim)) is None
    cap = 7
    assert costim_lists(torch.from_numpy(stim)).hmax == 7
    rows = int((torch.from_numpy(stim) != 0).sum(1).max())
    assert seen == [(100, 200, 7, rows, 200 * 49, torch.float64)] * 2
    cap = 0
    assert costim_lists(torch.from_numpy(stim), always=True).hmax == 7
    assert len(seen) == 2
    assert costim_lists(torch.zeros(5, 0), always=True) is None


def test_lists_of_a_design_with_no_target():
    lists = costim_lists(torch.zeros(6, 9), always=True)
    assert lists.hmax == 0 and lists.row_trials.numel() == 0
    assert lists.row_ptr.tolist() == [0] * 7
    assert lists.trial_ptr.tolist() == [0] * 10


@pytest.mark.parametrize("N,K,H", [(40, 300, 1), (200, 600, 10),
                                   (300, 400, 96)])
def test_gram_over_the_lists_is_the_dense_product(N, K, H):
    stim, _ = _design(N, K, H, seed=N)
    lam = torch.from_numpy(_posterior(stim, seed=K))
    lists = costim_lists(torch.from_numpy(stim), always=True)
    dense = lam @ lam.mT
    got = _index_add_gram(lam, lists)
    assert torch.max(torch.abs(got - dense)) <= 1e-12 * torch.max(dense)
    assert torch.equal(got[3], torch.zeros(N, dtype=lam.dtype))


# ---------------------------------------------------------------------------
# The dispatch
# ---------------------------------------------------------------------------


# (N, K, most targets a trial, most trials a neuron, pairs, dtype, W1 the
# faster): designs timed by chip_smoke.py's phase 3e on an H100, the
# comment W1's time over the dense product's
F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("N,K,hmax,row_trials,pairs,dtype,takes", [
    (1000, 20000, 10, 258, 2000000, F32, True),      # map1000: 0.08
    (2000, 40000, 10, 251, 4000000, F32, True),      # map2000: 0.02
    (2000, 40000, 10, 251, 4000000, F64, True),      # 0.02
    (300, 6000, 10, 242, 600000, F32, False),        # even: 1.22
    (400, 8000, 10, 253, 800000, F64, True),         # even: 0.77
    (500, 10000, 20, 459, 4000000, F32, True),       # even: 0.92
    (500, 10000, 20, 459, 4000000, F64, False),      # even: 1.11
    (500, 10000, 30, 672, 9000000, F32, False),      # even: 1.44
    (1000, 20000, 60, 1313, 72000000, F32, True),    # even: 0.96
    (1000, 20000, 60, 1313, 72000000, F64, False),   # even: 1.69
    (1000, 20000, 80, 1712, 128000000, F32, False),  # even: 1.49
    (2000, 40000, 96, 2063, 368640000, F32, True),   # even: 0.74
    (2000, 40000, 96, 2063, 368640000, F64, False),  # even: 1.56
    (1000, 20000, 59, 666, 23606954, F64, True),     # uneven: 0.69
    (2000, 40000, 79, 906, 84921584, F32, True),     # uneven: 0.18
    (1000, 20000, 10, 2003, 2000000, F32, True),     # hot: 0.44
    (1000, 20000, 40, 10718, 32000000, F32, False),  # hot: 4.18
    (2000, 40000, 40, 9605, 64000000, F64, True),    # hot: 0.59
    (500, 10000, 20, 3872, 4000000, F32, False),     # hot: 6.79
    (4000, 100000, 97, 2500, 100000 * 97 * 97, F32, False),  # past 96
    (100, 300, 40, 130, 300 * 40 * 40, F32, False),  # the int8 bucket's
    (1000, 20000, 10, 258, 2000000, torch.bfloat16, False),  # no instance
])
def test_the_rule_follows_the_measured_crossover(N, K, hmax, row_trials,
                                                 pairs, dtype, takes):
    assert takes_w1(N, K, hmax, row_trials, pairs, dtype) is takes


def test_the_cpu_and_a_stack_keep_the_dense_product(monkeypatch):
    # a rule that takes every design: the CPU and the stack alone keep the
    # dense product
    monkeypatch.setattr(gram_cuda, "takes_w1", lambda *a: True)
    gram_cuda.reset_launches(costim_gram)
    _cpu_fit(iters=3)
    assert costim_gram.plans == {"dense": 3}
    _stacked_fit(iters=2)
    assert costim_gram.plans == {"dense": 5}
    assert costim_gram.launches == 0


def test_gram_without_lists_is_the_dense_product_and_counted():
    gram_cuda.reset_launches(costim_gram)
    lam = torch.from_numpy(_posterior(_design(30, 100, 4)[0]))
    assert torch.equal(gram(lam), lam @ lam.mT)
    stack = torch.stack([lam, 2 * lam])
    assert torch.equal(gram(stack), stack @ stack.mT)
    assert costim_gram.plans == {"dense": 2}
    assert costim_gram.launches == costim_gram.launches_f64 == 0


def _cpu_fit(N=30, K=300, H=3, iters=8, **kw):
    import circuitmap_torch as cm

    np.random.seed(7)
    sim = cm.simulate(N=N, trials=K, H=H, connection_prob=0.2,
                      verbose=False, device="cpu")
    p = default_priors(N)
    out = cav.caviar(sim["psc"], sim["stim_matrix"], p["mu"], p["beta"],
                     p["shape"], p["rate"], p["phi"], p["phi_cov"],
                     iters=iters, update_order="identity", analytic_mc=True,
                     verbose=False, device="cpu", **kw)
    return sim, out


@pytest.mark.parametrize("block", [1, 8])
def test_cpu_fits_keep_lam_zero_off_the_stim(block):
    gram_cuda.reset_launches(costim_gram)
    sim, out = _cpu_fit(sweep_block_size=block)
    lam = out[2]
    assert torch.all(lam[torch.from_numpy(sim["stim_matrix"]) == 0] == 0)
    assert costim_gram.plans == {"dense": 8}
    assert costim_gram.launches == 0


def _stacked_fit(iters):
    import circuitmap_torch as cm

    np.random.seed(3)
    sims = [cm.simulate(N=20, trials=150, H=3, connection_prob=0.2,
                        verbose=False, device="cpu") for _ in range(2)]
    p = default_priors(20)
    cm.caviar_many(np.stack([s["psc"] for s in sims]),
                   np.stack([s["stim_matrix"] for s in sims]), p["mu"],
                   p["beta"], p["shape"], p["rate"], p["phi"], p["phi_cov"],
                   iters=iters, device="cpu", compile_mode="batched",
                   verbose=False)


def test_a_stacked_fit_keeps_the_dense_product():
    gram_cuda.reset_launches(costim_gram)
    _stacked_fit(iters=4)
    assert costim_gram.plans == {"dense": 4}


def test_the_reconnection_scan_keeps_lam_zero_off_the_stim():
    stim, _ = _design(30, 400, 4, seed=5)
    st = torch.from_numpy(stim)
    lam = torch.from_numpy(_posterior(stim, seed=6))
    mu = torch.full((30,), 2.0, dtype=torch.float64)
    mu[7] = 0.0                                  # disconnected: a candidate
    # spontaneous events on every trial of neuron 7 and a few others
    z = torch.where(st[7] != 0, 3.0, 0.0).to(torch.float64)
    z[torch.arange(0, 400, 37)] = 1.5
    powers = torch.tensor(POWERS, dtype=torch.float64)
    mu2, _, lam2, _, n_rec = cav._reconnect_scan_device(
        st, lam, mu, torch.ones(30, dtype=torch.float64), z, powers, 0.3, 3.0)
    assert n_rec >= 1 and mu2[7] > 0
    assert torch.all(lam2[st == 0] == 0)
    assert torch.all(lam2[7][st[7] != 0] == 1.0)


# ---------------------------------------------------------------------------
# The launch plan and the wrapper
# ---------------------------------------------------------------------------


def test_plan():
    # the benchmark's shapes: the row whole in one block, odd strides
    assert gram_cuda.plan(2000, 400000, 10, 4) == (
        11, 2000, 1, 2000 * 4 + 32 * 11 * 8, 1563)
    assert gram_cuda.plan(1000, 3000, 10, 8) == (
        11, 1000, 1, 1000 * 8 + 32 * 11 * 12, 12)
    # the widest trials in float64: 1488 columns a block
    p = gram_cuda.plan(2000, 10, 96, 8)
    assert (p.stride, p.width, p.chunks) == (97, 1488, 2)
    assert p.smem <= gram_cuda.SMEM_BYTES and p.gather_blocks == 1
    for N, h, size in [(50000, 96, 4), (3, 0, 8), (1, 1, 4)]:
        p = gram_cuda.plan(N, 0, h, size)
        assert p.stride % 2 == 1 and p.stride >= h
        assert p.smem <= gram_cuda.SMEM_BYTES and p.width * p.chunks >= N
        assert p.width * (p.chunks - 1) < N
    with pytest.raises(ValueError, match="at most 96"):
        gram_cuda.plan(2000, 0, 97, 4)


def test_the_wrapper_refuses_what_it_does_not_take():
    stim, _ = _design(20, 50, 3)
    lists = costim_lists(torch.from_numpy(stim), always=True)
    with pytest.raises(ValueError, match="no costim_gram kernel"):
        costim_gram(torch.from_numpy(_posterior(stim)), lists)
    with pytest.raises(TypeError, match="float32 or float64"):
        costim_gram(torch.zeros(20, 50, dtype=torch.float16), lists)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card_case(N, K, H, dtype, device, seed=0):
    """A column-sparse design of exactly H targets a trial, built on the
    card, and a posterior that is zero off it."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = torch.argsort(torch.rand(K, N, generator=g, device=device),
                         dim=1)[:, :H]
    stim = torch.zeros(N, K, dtype=dtype, device=device)
    levels = torch.tensor(POWERS, dtype=dtype, device=device)
    stim[rows.T, torch.arange(K, device=device).expand(H, K)] = levels[
        torch.randint(0, 3, (H, K), generator=g, device=device)]
    lam = torch.where(stim > 0, torch.rand(N, K, generator=g, device=device,
                                           dtype=dtype), 0.0)
    return stim, lam


def _ulps(a, b):
    """Largest distance in float32 units in the last place."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(torch.max(torch.abs(ia - ib)))


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1000, 20000), (2000, 40000)])
def test_w1_against_the_dense_product_at_the_benchmark_shapes(cuda, N, K):
    from circuitmap_torch._device import highest_matmul

    stim, lam = _card_case(N, K, 10, torch.float32, cuda)
    lists = costim_lists(stim)
    G = costim_gram(lam, lists)
    with highest_matmul():
        dense = lam @ lam.mT
    exact = lam.double() @ lam.double().mT
    # an element sums at most m nonnegative products in float32, one
    # rounding each: within (1 + u)^m - 1 of the exact sum, u = 2^-24,
    # m the most trials a neuron takes
    m = int(torch.max(lists.row_ptr[1:] - lists.row_ptr[:-1]))
    bound = (1 + 2.0 ** -24) ** m - 1
    nz = exact > 0
    err = torch.max(torch.abs(G.double() - exact)[nz] / exact[nz])
    dense_err = torch.max(torch.abs(dense.double() - exact)[nz] / exact[nz])
    print(f"N={N} K={K}: W1 {_ulps(G, dense)} ulp from the dense product; "
          f"relative to the exact Gram W1 {float(err):.3e}, the dense "
          f"product {float(dense_err):.3e}, bound {bound:.3e} (m={m})")
    assert torch.all(G[~nz] == 0)
    assert err <= bound
    assert torch.equal(G, G.T)
    assert torch.equal(costim_gram(lam, lists), G)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,H", [(1000, 20000, 10), (2000, 4000, 96)])
def test_w1_float64(cuda, N, K, H):
    stim, lam = _card_case(N, K, H, torch.float64, cuda, seed=1)
    lists = costim_lists(stim, always=True)
    G = costim_gram(lam, lists)
    dense = lam @ lam.mT
    assert torch.max(torch.abs(G - dense)) <= 1e-12 * torch.max(dense)
    assert torch.equal(G, G.T)
    assert torch.equal(costim_gram(lam, lists), G)


def _card_fit(N, K, H, iters, seed=0, **kw):
    import circuitmap_torch as cm

    np.random.seed(seed)
    sim = cm.simulate(N=N, trials=K, H=H, connection_prob=0.1,
                      verbose=False, device="cpu")
    p = default_priors(N)
    gram_cuda.reset_launches(costim_gram)
    out = cav.caviar(sim["psc"], sim["stim_matrix"], p["mu"], p["beta"],
                     p["shape"], p["rate"], p["phi"], p["phi_cov"],
                     iters=iters, verbose=False, device="cuda", **kw)
    torch.cuda.synchronize()
    return sim, out


@pytest.mark.cuda
def test_a_fit_takes_w1_every_iteration(cuda):
    sim, out = _card_fit(600, 10000, 10, 50)
    assert costim_gram.plans == {"costim": 50}
    assert costim_gram.launches == 50 and costim_gram.launches_f64 == 0
    stim = torch.as_tensor(sim["stim_matrix"], device=cuda)
    assert torch.all(out[2][stim == 0] == 0)


@pytest.mark.cuda
def test_a_float64_fit_takes_w1_in_double(cuda):
    _card_fit(600, 10000, 10, 5, dtype=torch.float64)
    assert costim_gram.plans == {"costim": 5}
    assert costim_gram.launches == costim_gram.launches_f64 == 5


@pytest.mark.cuda
def test_a_dense_design_keeps_the_dense_product_on_the_card(cuda):
    _card_fit(40, 1000, 30, 5)                # 30 of 40 targets a trial
    assert costim_gram.plans == {"dense": 5}
    assert costim_gram.launches == 0


@pytest.mark.cuda
def test_lam_stays_zero_off_the_stim_after_b1_and_a_reconnection(cuda):
    stim, _ = _design(300, 4000, 10, seed=9)
    st = torch.from_numpy(stim).to(cuda, torch.float32)
    lam = torch.from_numpy(_posterior(stim, seed=2)).to(cuda, torch.float32)
    mu = torch.full((300,), 2.0, device=cuda)
    mu[7] = 0.0
    z = torch.where(st[7] != 0, 3.0, 0.0)
    powers = torch.tensor(POWERS, device=cuda)
    _, _, lam2, _, n_rec = cav._reconnect_scan_device(
        st, lam, mu, torch.ones(300, device=cuda), z, powers, 0.3, 3.0)
    assert n_rec >= 1 and torch.all(lam2[st == 0] == 0)
    # and through a whole fit on B1 (8 rows a step) with its scan
    sim, out = _card_fit(300, 6000, 10, 20, seed=4)
    stim = torch.as_tensor(sim["stim_matrix"], device=cuda)
    assert torch.all(out[2][stim == 0] == 0)
