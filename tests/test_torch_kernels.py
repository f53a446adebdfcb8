"""circuitmap_torch's CUDA kernels against their plain PyTorch versions.

The tests marked ``cuda`` need an NVIDIA GPU and nvcc; they skip
without one. This file imports neither JAX nor circuitmap_tpu, so on a
machine with the card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

The rest checks, on any machine, what surrounds the kernels: dispatch
by device, launch counters and the build's failure without nvcc.

Tolerances. The sweep kernels (blocked and row, single and batched) run
the plain versions' float32 algebra with their sums in another order:
rtol 1e-4 / atol 1e-5 with the gate off, and with the gate on at most
one gate decision in 200 rows may flip (a borderline ``iso >= msrmp``
can fall either way under another reduction order). In a row sweep a
flip changes every later row through the residual, so with the gate on
only the decisions are compared. The Laplace kernel computes in double from float32
inputs and is held to the plain version run in float64 on the same
inputs, per neuron relative to its largest entry, at 1e-5. The float64
instances (the sweep in double, the Laplace kernel with double I/O) run
the same algebra as their float64 plain versions. The sweeps: 1e-10 of
the largest entry, and not one gate decision apart. The Laplace kernel
with double I/O: within 10 times the distance the float64 plain version
itself moves when its input S moves by one ulp (``laplace_ulp_spread``:
~1e-9 on phi, ~1e-8 on cov at these inputs; the card measured the
kernel 1.0e-8 / 2.8e-8 from it), not 1e-10, which the recursion's own
conditioning does not allow. The U-Net's epilogue kernel (ReLU, linear
resize, skip concat) is held to ATen's ops: float32, bfloat16 and
float16 within one ulp of each output in their own type (it computes
ATen's arithmetic, the 16-bit types in float as ATen's kernel does; one
ulp leaves room for the contraction of a multiply-add), float64 within
1e-12.
"""

import numpy as np
import pytest
import torch

from circuitmap_torch.ops import (_build, laplace_cuda, resize_cuda,
                                  sweep_cuda, sweep_row_cuda)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _sweep_inputs(N, K, powers, seed=0, device="cpu", H=None,
                  connected=0.2, block=8):
    rng = np.random.default_rng(seed)
    H = max(1, N // 10) if H is None else H
    stim = np.zeros((N, K), np.float32)
    stim[rng.integers(0, N, H * K), np.repeat(np.arange(K), H)] = rng.choice(
        powers, H * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0).astype(np.float32)
    mu = np.where(rng.random(N) < connected, rng.uniform(5, 30, N), 0).astype(
        np.float32)
    y = (mu @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)).astype(
        np.float32)
    d = dict(y=y, stim=stim, mu=mu,
             beta=rng.uniform(0.5, 2, N).astype(np.float32), lam=lam,
             m0=rng.uniform(0.2, 0.25, N).astype(np.float32),
             m1=rng.uniform(10, 15, N).astype(np.float32),
             lam_mask=(rng.random(K) > 0.05).astype(np.float32),
             powers=np.asarray(powers, np.float32))
    t = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
    t["power_counts"] = torch.stack(
        [(t["stim"] == p).sum(1) for p in t["powers"]], 1).float()
    t["border"] = torch.from_numpy(
        rng.permutation(-(-N // block))).to(device)
    return t


def _sweep(fn, t, gate, msrmp=0.5, **kw):
    return fn(t["y"], t["stim"], t["mu"], t["beta"], t["lam"], 0.1, t["m0"],
              t["m1"], t["lam_mask"], t["powers"], t["power_counts"],
              t["border"], msrmp, 3.0, gate, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,powers", [
    (29, 300, (45.0, 55.0, 65.0)),        # a partial padding block
    (29, 301, (45.0, 55.0, 65.0)),        # K % 4 != 0: rows unaligned
    (203, 5000, (45.0, 55.0, 65.0)),
    (64, 1000, (50.0,)),
    (64, 1000, (30.0, 40.0, 50.0, 60.0, 70.0)),
])
def test_sweep_kernel_matches_plain(cuda, N, K, powers):
    t = _sweep_inputs(N, K, powers, device=cuda)
    before = sweep_cuda.sweep_spikes_blocked.launches
    ker = _sweep(sweep_cuda.sweep_spikes_blocked, t, 0.0)
    plain = _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, 0.0)
    torch.testing.assert_close(ker, plain, rtol=1e-4, atol=1e-5)
    ker1 = _sweep(sweep_cuda.sweep_spikes_blocked, t, 1.0)
    plain1 = _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, 1.0)
    torch.cuda.synchronize()
    assert sweep_cuda.sweep_spikes_blocked.launches == before + 2
    off_k, off_p = ker1.sum(1) == 0, plain1.sum(1) == 0
    assert int((off_k != off_p).sum()) <= max(0, N // 200)
    same = ~(off_k | off_p)
    torch.testing.assert_close(ker1[same], plain1[same], rtol=1e-4, atol=1e-5)


SIXTEEN_LEVELS = tuple(30.0 + 3.0 * p for p in range(16))


def _levels(n):
    """n distinct power levels from 30 up, 0.05 apart past 16."""
    return tuple(float(v) for v in 30.0 + 0.05 * np.arange(n))


@pytest.mark.cuda
@pytest.mark.parametrize("block,N,K,powers", [
    (7, 29, 300, (45.0, 55.0, 65.0)),     # a partial last block
    (7, 203, 5001, (45.0, 55.0, 65.0)),   # K % 4 != 0
    (12, 203, 5000, (45.0, 55.0, 65.0)),
    (16, 203, 5000, (45.0, 55.0, 65.0)),
    (32, 203, 5000, (45.0, 55.0, 65.0)),  # four groups of 8 rows a step
    (8, 203, 5000, SIXTEEN_LEVELS),       # two groups of 4 rows a step
    (32, 64, 20000, SIXTEEN_LEVELS),      # r and est off chip
    # more levels than the compile-time instances: sums in global scratch
    (8, 203, 5000, _levels(24)),
    (8, 203, 5000, _levels(64)),
    (8, 64, 20000, _levels(1024)),
    (1, 64, 3000, _levels(24)),           # the strictly sequential sweep
    # blocks of more than one warp's rows: sub-steps against one residual
    (48, 203, 5000, (45.0, 55.0, 65.0)),
    (64, 203, 5001, (45.0, 55.0, 65.0)),
    (125, 300, 5000, (45.0, 55.0, 65.0)),
    (48, 203, 5000, _levels(24)),
    # K=40,000 at 8 rows a step: on chip with no room for the prefetch
    # ring (the N=2000, K=40,000 map's plan, depth 0)
    (8, 203, 40000, (45.0, 55.0, 65.0)),
])
def test_sweep_kernel_matches_plain_at_pinned_blocks_and_levels(
        cuda, block, N, K, powers):
    # the main path's kind of inputs (at most 10 targets a trial, ~5%
    # connected): with 20 targets and 20% connected the float32 plain
    # version alone sits up to 6e-4 from float64 at N=203, and a
    # comparison at atol 1e-5 says nothing about the kernel
    t = _sweep_inputs(N, K, powers, device=cuda, block=block,
                      H=min(10, max(1, N // 10)), connected=0.05)
    kw = dict(block_size=block)
    fn = sweep_cuda.sweep_spikes_blocked
    plan = sweep_cuda.launch_plan(1, K, sweep_cuda.sub_steps(block)[1],
                                  len(powers))
    # each launch counts its plan: layout, ring depth and block steps
    launch = sweep_cuda.SweepLaunch(plan.cluster, plan.cols, plan.on_chip,
                                    plan.depth, -(-N // block))
    before, before_plan = fn.launches, fn.plans.get(launch, 0)
    ker = _sweep(fn, t, 0.0, **kw)
    plain = _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, 0.0, **kw)
    torch.testing.assert_close(ker, plain, rtol=1e-4, atol=1e-5)
    ker1 = _sweep(fn, t, 1.0, **kw)
    plain1 = _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, 1.0, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert fn.plans[launch] == before_plan + 2
    off_k, off_p = ker1.sum(1) == 0, plain1.sum(1) == 0
    assert int((off_k != off_p).sum()) <= max(0, N // 200)


def _stacked(E, N, K, powers, device, seed=0):
    """E experiments of sweep inputs with a leading axis, a row order
    and a block order each. The row kernel's inputs are the main path's
    kind (at most 10 targets a trial, ~5% connected): with 20 targets
    and 20% connected, N=203 rows of residual updates leave both float32
    versions ~2e-4 from the float64 result, and their comparison at
    atol 1e-5 says nothing about the kernel."""
    parts = [_sweep_inputs(N, K, powers, seed=seed + e, device=device,
                           H=min(10, max(1, N // 10)), connected=0.05)
             for e in range(E)]
    t = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    t["powers"] = parts[0]["powers"]
    rng = np.random.default_rng(seed)
    t["order"] = torch.from_numpy(
        np.stack([rng.permutation(N) for _ in range(E)])).to(device)
    return t


def _row(fn, t, gate, msrmp=0.5, sig=0.1):
    return fn(t["y"], t["stim"], t["mu"], t["beta"], t["lam"], sig, t["m0"],
              t["m1"], t["lam_mask"], t["powers"], t["power_counts"],
              t["order"], msrmp, 3.0, gate)


def _check_row_kernel(fn, plain_fn, t, msrmp=0.5, sig=0.1):
    """Gate off: the kernel against the plain version at rtol 1e-4 /
    atol 1e-5; gate on: at most one gate decision in 200 rows may
    differ. Returns the gated kernel output."""
    ker = _row(fn, t, 0.0, msrmp, sig)
    plain = _row(plain_fn, t, 0.0, msrmp, sig)
    torch.testing.assert_close(ker, plain, rtol=1e-4, atol=1e-5)
    ker1 = _row(fn, t, 1.0, msrmp, sig)
    plain1 = _row(plain_fn, t, 1.0, msrmp, sig)
    off_k, off_p = ker1.sum(-1) == 0, plain1.sum(-1) == 0
    assert int((off_k != off_p).sum()) <= max(0, off_k.numel() // 200)
    return ker1


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,powers,on_chip", [
    (29, 300, (45.0, 55.0, 65.0), True),
    (203, 5000, (45.0, 55.0, 65.0), True),
    (64, 1000, (50.0,), True),
    (64, 1000, (30.0, 40.0, 50.0, 60.0, 70.0), True),
    (29, 301, (45.0, 55.0, 65.0), True),
    # past the old single-block kernels' shared-memory limit
    (40, 60000, (45.0, 55.0, 65.0), True),
    # past the widest slice kept on chip: r in device memory
    (24, 300000, (45.0, 55.0, 65.0), False),
])
def test_row_kernel_matches_plain(cuda, N, K, powers, on_chip):
    plan = sweep_cuda.launch_plan(1, K, 1, len(powers))
    assert plan.on_chip == on_chip and plan.depth >= 1
    t = _stacked(1, N, K, powers, cuda)
    t = {k: (v if k == "powers" else v[0]) for k, v in t.items()}
    before = sweep_row_cuda.sweep_spikes_row.launches
    _check_row_kernel(sweep_row_cuda.sweep_spikes_row,
                      sweep_row_cuda.sweep_spikes_row_torch, t)
    torch.cuda.synchronize()
    assert sweep_row_cuda.sweep_spikes_row.launches == before + 2


@pytest.mark.cuda
def test_batched_row_kernel_matches_plain(cuda):
    t = _stacked(3, 101, 3000, (45.0, 55.0, 65.0), cuda, seed=4)
    sig = torch.tensor([0.1, 0.15, 0.08], device=cuda)
    msrmp = torch.tensor([0.3, 0.5, 0.7], device=cuda)
    before = sweep_row_cuda.sweep_spikes_row_batched.launches
    ker1 = _check_row_kernel(sweep_row_cuda.sweep_spikes_row_batched,
                             sweep_row_cuda.sweep_spikes_row_batched_torch,
                             t, msrmp, sig)
    torch.cuda.synchronize()
    assert sweep_row_cuda.sweep_spikes_row_batched.launches == before + 2
    # one launch of three equals three single launches
    for e in range(3):
        one = sweep_row_cuda.sweep_spikes_row(
            *(t[k][e] for k in ("y", "stim", "mu", "beta", "lam")), sig[e],
            t["m0"][e], t["m1"][e], t["lam_mask"][e], t["powers"],
            t["power_counts"][e], t["order"][e], msrmp[e], 3.0, 1.0)
        torch.testing.assert_close(one, ker1[e], rtol=0, atol=0)


@pytest.mark.cuda
def test_batched_blocked_kernel_matches_plain(cuda):
    t = _stacked(3, 203, 5000, (45.0, 55.0, 65.0), cuda, seed=7)
    msrmp = torch.tensor([0.3, 0.5, 0.7], device=cuda)
    before = sweep_cuda.sweep_spikes_blocked_batched.launches
    ker = _sweep(sweep_cuda.sweep_spikes_blocked_batched, t, 0.0, msrmp)
    plain = _sweep(sweep_cuda.sweep_spikes_blocked_batched_torch, t, 0.0,
                   msrmp)
    ker1 = _sweep(sweep_cuda.sweep_spikes_blocked_batched, t, 1.0, msrmp)
    plain1 = _sweep(sweep_cuda.sweep_spikes_blocked_batched_torch, t, 1.0,
                    msrmp)
    torch.cuda.synchronize()
    assert sweep_cuda.sweep_spikes_blocked_batched.launches == before + 2
    torch.testing.assert_close(ker, plain, rtol=1e-4, atol=1e-5)
    off_k, off_p = ker1.sum(-1) == 0, plain1.sum(-1) == 0
    assert int((off_k != off_p).sum()) <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("mapping", ["sns", "ard"])
def test_row_kernel_at_the_solver_mappings(cuda, mapping):
    """B3 at the arguments CAVI-SnS and MBCS-ARD give it, through the
    solvers' own sweeps (``cavi_sns.sweep_spikes_sns``: weights mu*alpha,
    the slab scale beta_eff, the gate on at threshold -1;
    ``experimental.sweep_spikes_ard``: means (0, -logit), the gate off),
    against their plain versions on the same inputs on the CPU. ARD at
    rtol 1e-4 / atol 1e-5; SnS's count gate may flip one decision in 200
    rows, and with none flipped is held as ARD."""
    import importlib

    cavi_sns = importlib.import_module("circuitmap_torch.solvers.cavi_sns")
    experimental = importlib.import_module(
        "circuitmap_torch.solvers.experimental")
    N = 203
    t = _stacked(1, N, 5000, (45.0, 55.0, 65.0), cuda, seed=9)
    t = {k: (v if k == "powers" else v[0]) for k, v in t.items()}
    t["alpha"] = torch.from_numpy(np.random.default_rng(9).uniform(
        0.05, 1.0, N).astype(np.float32)).to(cuda)

    def run(d):
        if mapping == "sns":
            return cavi_sns.sweep_spikes_sns(
                d["y"], d["stim"], d["mu"], d["beta"], d["alpha"], d["lam"],
                0.1, d["m0"], d["m1"], d["lam_mask"], d["order"], 3.0,
                d["powers"], d["power_counts"])
        return experimental.sweep_spikes_ard(
            d["y"], d["stim"], d["mu"], d["beta"], d["lam"], 10.0,
            d["lam_mask"], d["powers"][:1], d["power_counts"][:, :1],
            d["order"], float(np.log(3.0)))

    before = sweep_row_cuda.sweep_spikes_row.launches
    ker = run(t)
    torch.cuda.synchronize()
    assert sweep_row_cuda.sweep_spikes_row.launches == before + 1
    plain = run({k: v.cpu() for k, v in t.items()})
    ker = ker.cpu()
    off_k, off_p = ker.sum(-1) == 0, plain.sum(-1) == 0
    flips = int((off_k != off_p).sum())
    assert flips <= (N // 200 if mapping == "sns" else 0)
    if flips == 0:
        torch.testing.assert_close(ker, plain, rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_row_versions():
    t = _stacked(2, 29, 300, (45.0, 55.0, 65.0), "cpu")
    before = sweep_row_cuda.sweep_spikes_row_batched.launches
    torch.testing.assert_close(
        _row(sweep_row_cuda.sweep_spikes_row_batched, t, 1.0),
        _row(sweep_row_cuda.sweep_spikes_row_batched_torch, t, 1.0),
        rtol=0, atol=0)
    assert sweep_row_cuda.sweep_spikes_row_batched.launches == before


def _laplace_stats(N, P1, seed=0):
    rng = np.random.default_rng(seed)
    levels = np.concatenate([[0.0], 45.0 + 10.0 * np.arange(P1 - 1)])
    C = rng.integers(20, 400, (N, P1)).astype(np.float64)
    C[:, 0] = rng.integers(2000, 8000, N)
    p = 1 / (1 + np.exp(-(rng.uniform(0.15, 0.3, N)[:, None] * levels
                          - rng.uniform(8, 16, N)[:, None])))
    S = np.clip(C * p + rng.normal(0, 2, (N, P1)), 0, C)
    S[:3] = 0.0
    pp = np.tile([0.1, 5.0], (N, 1))
    pc = np.tile([[1e-1, 0.0], [0.0, 1e0]], (N, 1, 1))
    return [torch.from_numpy(a.astype(np.float32))
            for a in (S, C, levels, pp, pc)]


@pytest.mark.cuda
@pytest.mark.parametrize("P1", [2, 4, 6, 16, 17, 25, 65, 1025])
def test_laplace_kernel_matches_plain_float64(cuda, P1):
    args = [a.to(cuda) for a in _laplace_stats(300, P1, seed=P1)]
    before = laplace_cuda.laplace_from_stats.launches
    phi, cov = laplace_cuda.laplace_from_stats(*args)
    torch.cuda.synchronize()
    assert laplace_cuda.laplace_from_stats.launches == before + 1
    assert phi.dtype == torch.float32 and cov.shape == (300, 2, 2)
    phi64, cov64 = laplace_cuda.laplace_from_stats_torch(
        *(a.double() for a in args))
    assert (phi - phi64).abs().max() / phi64.abs().max() < 1e-5
    per = (cov.double() - cov64).abs().flatten(1).amax(1) \
        / cov64.abs().flatten(1).amax(1)
    assert per.max() < 1e-5


# the classes of the first accepted Armijo index j that the kernel's
# lane-parallel search takes apart at 8 lanes a neuron (and at 16 or
# 32): the first round, a later lane of it, later rounds, the last
# round, and no acceptance (the 0.5^40 fallback, j = 41 here)
ARMIJO_CLASSES = {"0": (0, 0), "1-7": (1, 7), "8-15": (8, 15),
                  "16-31": (16, 31), "32-40": (32, 40), "none": (41, 41)}


def armijo_lanes():
    """Never-spiking neurons (S = 0) with 10^2..10^9 trials in each
    bucket, prior means phi0 from 0.2 to 50 (far above the data) and a
    prior covariance of 1e10: the saturated likelihood's gradient makes
    the Newton step so long that the first accepted j spans every class
    of ARMIJO_CLASSES, and at 10^8..10^9 trials even 0.5^40 leaves phi0
    negative, so nothing is accepted."""
    c, q = np.meshgrid(10.0 ** np.arange(2, 10), [0.2, 1.0, 5.0, 20.0, 50.0],
                       indexing="ij")
    n = c.size
    C = np.repeat(c.reshape(n, 1), 4, 1)
    pp = np.stack([q.ravel(), np.full(n, 5.0)], 1)
    pc = np.tile(np.diag([1e10, 1e10]), (n, 1, 1))
    return [torch.from_numpy(a.astype(np.float32)) for a in
            (np.zeros_like(C), C, np.array([0.0, 45.0, 55.0, 65.0]), pp, pc)]


def armijo_classes_present(args):
    j = laplace_cuda.accepted_steps(*(a.double() for a in args))
    return {name: bool(((j >= lo) & (j <= hi)).any())
            for name, (lo, hi) in ARMIJO_CLASSES.items()}


def _first_acceptance(S, C, lev, pp, pc):
    """One lane's first accepted Armijo j at each Newton step, by the
    sequential rule (try 0.5^j for j = 0, 1, ... and stop at the first
    acceptance), in float64 numpy scalars: MAX_BACKTRACK + 1 where none
    is accepted."""
    q = np.linalg.inv(pc)

    def objective(c):
        x = c[0] * lev - c[1]
        with np.errstate(all="ignore"):
            ll = S * -np.logaddexp(0, -x) + (C - S) * -np.logaddexp(0, x)
            return (-np.nan_to_num(ll).sum() - np.log(c).sum() / 10.0
                    + 0.5 * (c - pp) @ q @ (c - pp))

    phi, js = pp.copy(), []
    for _ in range(laplace_cuda.NEWTON_STEPS):
        f = 1 / (1 + np.exp(-(phi[0] * lev - phi[1])))
        r, w = S - C * f, C * f * (1 - f)
        g = np.array([-(lev * r).sum(), r.sum()]) + q @ (phi - pp) \
            - 1 / (10.0 * phi)
        H = np.array([[(lev * lev * w).sum(), -(lev * w).sum()],
                      [-(lev * w).sum(), w.sum()]]) + q \
            + np.diag(1 / (10.0 * phi * phi))
        v = -np.linalg.solve(H, g)
        f0, j = objective(phi), laplace_cuda.MAX_BACKTRACK + 1
        for k in range(laplace_cuda.MAX_BACKTRACK + 1):
            lhs = objective(phi + 0.5 ** k * v)
            if not np.isnan(lhs) and lhs <= f0 + 0.25 * 0.5 ** k * (g @ v):
                j = k
                break
        js.append(j)
        phi = phi + 0.5 ** min(j, laplace_cuda.MAX_BACKTRACK) * v
    return js


def test_accepted_steps_are_the_sequential_first_acceptance():
    # the trip counts behind chip_smoke's Laplace bound, against the
    # sequential rule on lanes of every class
    args = [a.double() for a in armijo_lanes()]
    j = laplace_cuda.accepted_steps(*args)
    assert int(j.max()) == laplace_cuda.MAX_BACKTRACK + 1
    for n in range(0, args[0].shape[0], 3):
        want = _first_acceptance(args[0][n].numpy(), args[1][n].numpy(),
                                 args[2].numpy(), args[3][n].numpy(),
                                 args[4][n].numpy())
        assert j[n].tolist() == want, n


def test_shared_prior_is_read_in_place():
    # a prior shared by the experiments of a batch reaches the kernel
    # uncopied, as [N] rows that lane n reads at n mod N
    E, N = 3, 7
    S = torch.rand(E, N, 4)
    pp, pc = torch.rand(N, 2), torch.rand(N, 2, 2)
    args, phi, cov = laplace_cuda._prepare(
        S, S, torch.rand(4), pp.expand(E, N, 2), pc.expand(E, N, 2, 2))
    _, _, _, pp_k, pc_k, *_, n, P1, n_pp, n_pc = args
    assert (n, P1, n_pp, n_pc) == (E * N, 4, N, N)
    assert pp_k.data_ptr() == pp.data_ptr()
    assert pc_k.data_ptr() == pc.data_ptr()
    assert phi.shape == (E, N, 2) and cov.shape == (E, N, 2, 2)
    lanes = torch.arange(E * N)
    torch.testing.assert_close(pc_k[lanes % n_pc],
                               pc.expand(E, N, 2, 2).reshape(-1, 2, 2),
                               rtol=0, atol=0)
    # one prior for every lane: one row; a prior that varies along the
    # experiments but not the neurons: materialised per lane
    pc_e = torch.rand(E, 1, 2, 2)
    args, *_ = laplace_cuda._prepare(
        S, S, torch.rand(4), torch.tensor([0.1, 5.0]).expand(E, N, 2),
        pc_e.expand(E, N, 2, 2))
    assert args[-2:] == (1, E * N)
    torch.testing.assert_close(args[4],
                               pc_e.expand(E, N, 2, 2).reshape(-1, 2, 2),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_laplace_kernel_armijo_edge_cases(cuda):
    args = armijo_lanes()
    assert all(armijo_classes_present(args).values())
    phi, cov = laplace_cuda.laplace_from_stats(*(a.to(cuda) for a in args))
    phi64, cov64 = laplace_cuda.laplace_from_stats_torch(
        *(a.to(cuda).double() for a in args))
    for got, want in ((phi, phi64), (cov, cov64)):
        per = (got.double() - want).abs().flatten(1).amax(1) \
            / want.abs().flatten(1).amax(1)
        assert per.max() < 1e-5


@pytest.mark.cuda
def test_laplace_kernel_flattens_batch_dims(cuda):
    a = _laplace_stats(50, 4, seed=1)
    b = _laplace_stats(50, 4, seed=2)
    stacked = [torch.stack([x, y]).to(cuda) for x, y in zip(a, b)]
    stacked[2] = a[2].to(cuda)  # one shared level table
    before = laplace_cuda.laplace_from_stats.launches
    phi, cov = laplace_cuda.laplace_from_stats(*stacked)
    assert laplace_cuda.laplace_from_stats.launches == before + 1
    assert phi.shape == (2, 50, 2) and cov.shape == (2, 50, 2, 2)
    for i, args in enumerate((a, b)):
        p1, c1 = laplace_cuda.laplace_from_stats(*(x.to(cuda) for x in args))
        torch.testing.assert_close(phi[i], p1, rtol=0, atol=0)
        torch.testing.assert_close(cov[i], c1, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    t = _sweep_inputs(16, 200, (45.0, 55.0), device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        _sweep(sweep_cuda.sweep_spikes_blocked,
               {k: (v.half() if v.is_floating_point() else v)
                for k, v in t.items()}, 1.0)
    with pytest.raises(ValueError, match="block_size"):
        sweep_cuda.sweep_spikes_blocked(
            t["y"], t["stim"], t["mu"], t["beta"], t["lam"], 0.1, t["m0"],
            t["m1"], t["lam_mask"], t["powers"], t["power_counts"],
            t["border"], 0.3, 3.0, 1.0, block_size=0)
    none = dict(t, powers=t["powers"][:0], power_counts=t["power_counts"][:, :0])
    with pytest.raises(ValueError, match="power level"):
        _sweep(sweep_cuda.sweep_spikes_blocked, none, 1.0)
    # both wrappers take K past the old kernels' shared-memory limit
    wide = _stacked(1, 16, 56065, (45.0, 55.0), cuda)
    wide = {k: (v if k == "powers" else v[0]) for k, v in wide.items()}
    for fn, plain_fn, call in (
            (sweep_cuda.sweep_spikes_blocked,
             sweep_cuda.sweep_spikes_blocked_torch, _sweep),
            (sweep_row_cuda.sweep_spikes_row,
             sweep_row_cuda.sweep_spikes_row_torch, _row)):
        torch.testing.assert_close(call(fn, wide, 0.0),
                                   call(plain_fn, wide, 0.0),
                                   rtol=1e-4, atol=1e-5)
    args = [a.to(cuda).half() for a in _laplace_stats(8, 4)]
    with pytest.raises(TypeError, match="float32 or float64"):
        laplace_cuda.laplace_from_stats(*args)


def _f64(t):
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in t.items()}


def _hold_f64(ker, plain):
    """A float64 kernel against its float64 plain version: 1e-10 of the
    largest entry (the same algebra, sums in another order), and with
    the gate on not one gate decision apart."""
    assert ker.dtype == torch.float64
    assert (ker - plain).abs().max() <= 1e-10 * plain.abs().max()
    assert torch.equal(ker.sum(-1) == 0, plain.sum(-1) == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("block,N,K,powers", [
    (8, 203, 5000, (45.0, 55.0, 65.0)),
    (12, 100, 3001, (45.0, 55.0, 65.0)),
    (48, 203, 2000, (45.0, 55.0, 65.0)),
    (8, 64, 2000, tuple(30.0 + 2.0 * i for i in range(24))),
    # past the float64 form's on-chip limit (41,344 at 8 rows)
    (8, 16, 60000, (45.0, 55.0, 65.0)),
])
def test_sweep_kernel_matches_plain_float64(cuda, block, N, K, powers):
    t = _f64(_sweep_inputs(N, K, powers, device=cuda, block=block,
                           H=max(1, N // 10)))
    on_chip = sweep_cuda.launch_plan(
        1, K, sweep_cuda.sub_steps(block)[1], len(powers), 8).on_chip
    assert on_chip == (K < 41344)
    fn = sweep_cuda.sweep_spikes_blocked
    before, before64 = fn.launches, fn.launches_f64
    for gate in (0.0, 1.0):
        _hold_f64(_sweep(fn, t, gate, block_size=block),
                  _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, gate,
                         block_size=block))
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_f64) == (before + 2, before64 + 2)


@pytest.mark.cuda
def test_row_and_batched_kernels_match_plain_float64(cuda):
    t = _f64(_stacked(3, 101, 3000, (45.0, 55.0, 65.0), cuda, seed=4))
    one = {k: (v if k == "powers" else v[0]) for k, v in t.items()}
    for gate in (0.0, 1.0):
        _hold_f64(_row(sweep_row_cuda.sweep_spikes_row, one, gate),
                  _row(sweep_row_cuda.sweep_spikes_row_torch, one, gate))
        _hold_f64(_row(sweep_row_cuda.sweep_spikes_row_batched, t, gate),
                  _row(sweep_row_cuda.sweep_spikes_row_batched_torch, t,
                       gate))
        _hold_f64(_sweep(sweep_cuda.sweep_spikes_blocked_batched, t, gate),
                  _sweep(sweep_cuda.sweep_spikes_blocked_batched_torch, t,
                         gate))
    torch.cuda.synchronize()
    assert sweep_row_cuda.sweep_spikes_row_batched.launches_f64 >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("P1", [4, 17, 25])
def test_laplace_kernel_float64_io(cuda, P1):
    args = [a.to(cuda).double() for a in _laplace_stats(300, P1, seed=P1)]
    fn = laplace_cuda.laplace_from_stats
    before = fn.launches_f64
    phi, cov = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches_f64 == before + 1 and phi.dtype == torch.float64
    errs = _laplace_errors((phi, cov), laplace_cuda.laplace_from_stats_torch(
        *args))
    spread = laplace_ulp_spread(*args)
    assert all(e <= 10 * s for e, s in zip(errs, spread)), (errs, spread)


def _laplace_errors(got, want):
    """(phi's largest difference over its largest entry, the largest
    per-neuron difference of cov over that neuron's largest entry)."""
    (phi, cov), (phi64, cov64) = got, want
    per = (cov - cov64).abs().flatten(1).amax(1) \
        / cov64.abs().flatten(1).amax(1)
    return ((phi - phi64).abs().max() / phi64.abs().max()).item(), \
        per.max().item()


def laplace_ulp_spread(S, C, levels, pp, pc, seed=0):
    """How far the float64 plain version moves when S moves by one ulp
    (each entry up or down at random): ``_laplace_errors`` of the two.
    The recursion is ill-conditioned at closely spaced levels (the 2x2
    Hessian) and its Armijo ties fall either way, so on these inputs it
    moves by ~1e-9 (phi) and ~1e-8 (cov): no float64 implementation that
    sums in another order can sit closer than that to it."""
    g = torch.Generator(device=S.device).manual_seed(seed)
    sign = torch.randint(0, 2, S.shape, generator=g, device=S.device).to(
        S.dtype) * 2 - 1
    nudged = S * (1 + sign * torch.finfo(S.dtype).eps)
    return _laplace_errors(
        laplace_cuda.laplace_from_stats_torch(nudged, C, levels, pp, pc),
        laplace_cuda.laplace_from_stats_torch(S, C, levels, pp, pc))


def test_cpu_tensors_take_the_plain_versions():
    t = _sweep_inputs(29, 300, (45.0, 55.0, 65.0))
    before = sweep_cuda.sweep_spikes_blocked.launches
    got = _sweep(sweep_cuda.sweep_spikes_blocked, t, 1.0)
    torch.testing.assert_close(
        got, _sweep(sweep_cuda.sweep_spikes_blocked_torch, t, 1.0),
        rtol=0, atol=0)
    assert sweep_cuda.sweep_spikes_blocked.launches == before
    args = _laplace_stats(20, 4)
    before = laplace_cuda.laplace_from_stats.launches
    for g, w in zip(laplace_cuda.laplace_from_stats(*args),
                    laplace_cuda.laplace_from_stats_torch(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert laplace_cuda.laplace_from_stats.launches == before


def test_other_devices_raise():
    t = {k: v.to("meta") for k, v in _sweep_inputs(16, 100, (45.0,)).items()}
    with pytest.raises(ValueError, match="no sweep kernel"):
        _sweep(sweep_cuda.sweep_spikes_blocked, t, 1.0)
    args = [a.to("meta") for a in _laplace_stats(8, 2)]
    with pytest.raises(ValueError, match="no Laplace kernel"):
        laplace_cuda.laplace_from_stats(*args)


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_build_cache_key_follows_the_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest([src])
    assert _build._digest([src]) == first
    src.write_text("// two\n")
    assert _build._digest([src]) != first
    assert [p.name for p in _build._sources()] == ["k.cu"]


@pytest.mark.cuda
def test_demixer_is_deterministic_on_the_card(cuda):
    """Two demixes of one block agree bit for bit on the card, whether
    the block comes as float traces or as its int4d2 wire body (cuDNN's
    default transposed-convolution algorithm sums with atomics; the
    demixer asks for the deterministic ones)."""
    from circuitmap_torch.demix.demixer import NeuralDemixer
    from circuitmap_torch.utils.quant import (PackedInt4Traces,
                                              encode_int4_traces)

    rng = np.random.default_rng(0)
    raw = rng.standard_normal((5000, 900)) * rng.random((5000, 1))
    packed, scale = encode_int4_traces(raw, decimate=2)
    body = PackedInt4Traces(packed, scale, 900, 2)
    ck = "demixers/nwd_ie_ChroME2f_int4d2qat.npz"
    first = NeuralDemixer(ck, device=cuda)(
        raw, keep_on_device=True, transfer_dtype="int4d2", verbose=False)
    again = NeuralDemixer(ck, device=cuda)(
        body, keep_on_device=True, transfer_dtype="int4d2", verbose=False)
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_training_is_deterministic_on_the_card(cuda, monkeypatch):
    """With ``torch.backends.cudnn.deterministic`` set, two trainings of
    one network on the same pairs end bit for bit alike on the card,
    with the same history (the training resize is a product, with none
    of interpolate's atomic adds in its backward)."""
    from circuitmap_torch.demix.demixer import NeuralDemixer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((640, 900)) * 0.1).astype(np.float32)
    pairs = (x, np.maximum(x, 0) * 0.5)
    runs = []
    for _ in range(2):
        d = NeuralDemixer("demixers/nwd_ie_ChroME2f.npz", device=cuda)
        d.training_data, d.test_data = pairs, (x[:64], pairs[1][:64])
        hist = d.train(epochs=2, batch_size=64, verbose=False)
        runs.append((hist, d.net.state_dict()))
    (h1, s1), (h2, s2) = runs
    assert h1 == h2
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


@pytest.mark.cuda
def test_two_shard_mesh_on_one_card_matches_the_unsharded_fit(cuda):
    """A trial mesh of two shards on one card (the counterpart of JAX's
    virtual mesh) fits N=200, K=2,000 to the unsharded fit's gate
    pattern at the card's default 8 rows a block (the same random
    stream and schedule; the kernel's sums against the shards' plain
    ones, reassociated). The Laplace kernel launches once an
    iteration per distinct device; the sweep kernels not at all (the
    sharded sweep is plain PyTorch, its gate needs the global sums)."""
    from circuitmap_torch import default_priors, simulate
    from circuitmap_torch.parallel import caviar_sharded, trial_mesh
    from circuitmap_torch.solvers.caviar import caviar

    np.random.seed(2)
    sim = simulate(N=200, trials=2000, H=10, connection_prob=0.1,
                   verbose=False, device="cpu")
    p = default_priors(200)
    args = (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
            p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=10, seed=0, analytic_mc=True, fn_scan=False,
              verbose=False, sweep_block_size=8)
    single = caviar(*args, device=cuda, **kw)
    for fn in (laplace_cuda.laplace_from_stats, sweep_cuda.sweep_spikes_blocked,
               sweep_row_cuda.sweep_spikes_row):
        fn.launches = 0
    mesh = trial_mesh(devices=[cuda, cuda])
    sharded = caviar_sharded(*args, mesh=mesh, **kw)
    assert laplace_cuda.laplace_from_stats.launches == 10
    assert sweep_cuda.sweep_spikes_blocked.launches == 0
    assert sweep_row_cuda.sweep_spikes_row.launches == 0
    # one psum a block of 8 rows from iteration 2 on (the gate is off,
    # and the sweep psums nothing, up to delay_spont_est=1), besides the
    # other updates' psums
    assert mesh.psums >= (10 - 2) * 25
    assert torch.equal(single[0] != 0, sharded[0] != 0)
    np.testing.assert_allclose(sharded[0].cpu().numpy(),
                               single[0].cpu().numpy(), rtol=2e-3, atol=2e-3)


# (C, L_in, L_out, Cs) of the U-Net's up blocks ublock1..4 at 900 samples
UNET_UP = [(16, 32, 65, 32), (16, 80, 162, 16), (16, 193, 387, 16),
           (4, 804, 900, 0)]


def _aten_epilogue(h, size, skip):
    import torch.nn.functional as F

    out = F.interpolate(F.relu(h), size=size, mode="linear",
                        align_corners=False)
    return out if skip is None else torch.cat([out, skip], dim=1)


EPILOGUE_DTYPES = [torch.float32, torch.float64, torch.bfloat16,
                   torch.float16]


def _hold_epilogue(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
        return
    if want.dtype == torch.float32:
        ulp = torch.nextafter(want.abs(), torch.full_like(want, np.inf)) - \
            want.abs()
    else:  # the spacing of the 16-bit type at |want|, computed in float
        info = torch.finfo(want.dtype)
        w = want.float()
        ulp = torch.ldexp(torch.full_like(w, info.eps),
                          torch.frexp(w).exponent - 1)
        sub = info.tiny * info.eps  # the spacing of its subnormals
        ulp = torch.where(w == 0, sub, torch.clamp(ulp, min=sub))
        got, want = got.float(), w
    assert bool(((got - want).abs() <= ulp).all())


def _epilogue_inputs(B, C, L_in, L_out, Cs, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(B, C, L_in, generator=gen, dtype=torch.float64)
    skip = torch.randn(B, Cs, L_out, generator=gen, dtype=torch.float64)
    return h.to(device, dtype), skip.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", EPILOGUE_DTYPES)
@pytest.mark.parametrize("C,L_in,L_out,Cs", UNET_UP)
def test_epilogue_kernel_matches_aten(cuda, C, L_in, L_out, Cs, dtype):
    """At the U-Net's four up-block shapes, a whole chunk (4096 rows),
    the last chunk of a 20,000-trace map (3616) and one row, with and
    without the skip."""
    for B in (1, 4096, 3616):
        h, skip = _epilogue_inputs(B, C, L_in, L_out, Cs, dtype, cuda, B)
        for sk in ((skip, None) if Cs else (None,)):
            before = (resize_cuda.relu_resize_cat.launches,
                      resize_cuda.relu_resize_cat.launches_f64)
            got = resize_cuda.relu_resize_cat(h, L_out, sk)
            torch.cuda.synchronize()
            f64 = int(dtype == torch.float64)
            assert (resize_cuda.relu_resize_cat.launches,
                    resize_cuda.relu_resize_cat.launches_f64) == (
                        before[0] + 1, before[1] + f64)
            _hold_epilogue(got, _aten_epilogue(h, L_out, sk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", EPILOGUE_DTYPES)
def test_epilogue_kernel_off_the_unet_shapes(cuda, dtype):
    """The kernel's other paths: lines too long for one block (channel
    groups, each copying a share of the skip), a line longer than a
    block's shared memory (read from h, not staged), odd lengths and a
    misaligned tensor (no 16-byte vectors), a downsample and one input
    sample."""
    for B, C, L_in, L_out, Cs, offset in [
            (3, 5, 3000 if dtype == torch.float64 else 7000, 7001, 3, 0),
            (2, 3, 30000, 30001, 2, 0),
            (5, 3, 37, 101, 2, 0), (4, 4, 193, 387, 16, 1),
            (2, 6, 900, 450, 4, 0), (2, 3, 1, 4, 1, 0)]:
        h, skip = _epilogue_inputs(B, C, L_in, L_out, Cs, dtype, cuda)
        if offset:  # contiguous, one element past a 16-byte boundary
            flat = torch.empty(h.numel() + offset, dtype=dtype, device=cuda)
            h = flat[offset:].view_as(h).copy_(h)
        got = resize_cuda.relu_resize_cat(h, L_out, skip)
        _hold_epilogue(got, _aten_epilogue(h, L_out, skip))


@pytest.mark.cuda
def test_epilogue_kernel_repeats_bit_for_bit(cuda):
    h, skip = _epilogue_inputs(4096, 16, 193, 387, 16, torch.float32, cuda)
    first = resize_cuda.relu_resize_cat(h, 387, skip)
    assert torch.equal(resize_cuda.relu_resize_cat(h, 387, skip), first)


@pytest.mark.cuda
def test_demixer_launches_the_epilogue_kernel_four_times_a_chunk(cuda):
    """``NeuralDemixer.__call__`` on 4097 rows: two chunks, four up
    blocks each. A training step with autograd recording launches none
    (the kernel has no backward); its validation loss, under no_grad,
    does."""
    from circuitmap_torch.demix.demixer import NeuralDemixer

    rng = np.random.default_rng(0)
    raw = (rng.standard_normal((4097, 900)) * 0.1).astype(np.float32)
    d = NeuralDemixer("demixers/nwd_ie_ChroME2f.npz", device=cuda)
    fn = resize_cuda.relu_resize_cat
    before = fn.launches
    d(raw, verbose=False)
    assert fn.launches == before + 8
    x = torch.as_tensor(raw[:64], device=cuda)
    d.net.train()
    before = fn.launches
    d._loss(x, torch.relu(x)).backward()
    assert fn.launches == before
    d._val_loss(x, torch.relu(x))
    assert fn.launches == before + 4
    # a bfloat16 network takes the kernel too (no quiet way round it)
    bf16 = NeuralDemixer("demixers/nwd_ie_ChroME2f.npz", device=cuda,
                         compute_dtype=torch.bfloat16)
    before = fn.launches
    out = bf16(raw, verbose=False)
    assert fn.launches == before + 8 and np.isfinite(np.asarray(out)).all()


@pytest.mark.cuda
def test_epilogue_kernel_refuses_what_it_does_not_take(cuda):
    h, skip = _epilogue_inputs(2, 16, 193, 387, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="no relu_resize_cat kernel"):
        resize_cuda.relu_resize_cat(h.cpu(), 387, skip.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        resize_cuda.relu_resize_cat(h.transpose(0, 1), 387)
    with pytest.raises(ValueError, match="skip must be"):
        resize_cuda.relu_resize_cat(h, 387, skip[..., :386].contiguous())
    with pytest.raises(ValueError, match="skip must be"):
        resize_cuda.relu_resize_cat(h, 387, skip.cpu())
