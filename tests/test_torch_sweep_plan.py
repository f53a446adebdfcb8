"""The cluster sweep's launch plan (``sweep_cuda.cluster_plan``), a plain
host function the CUDA kernel takes its layout from: the CTAs' column
slices cover exactly the K trials, each starts on a 16-byte boundary,
and no CTA asks for more shared memory than sm_90 gives one
(232,448 bytes). Each launch counts its plan in its wrapper's
``plans``, which the launch path keeps on any machine."""

import types

import pytest
import torch

from circuitmap_torch.ops import _build, sweep_cuda
from circuitmap_torch.ops._counts import count_plan, reset_launches
from circuitmap_torch.ops.sweep_cuda import SweepLaunch, cluster_plan


@pytest.mark.parametrize("E", [1, 4, 9])
@pytest.mark.parametrize("K", [1, 300, 15000, 20000, 56065, 100000,
                               10 ** 6])
def test_plan_covers_k_within_shared_memory(K, E):
    for rows in (1, 7, 8, 12, 16, 32):
        for cluster in sweep_cuda.CLUSTER_SIZES:
            for P in (1, 3, sweep_cuda.MAX_POWERS, 24, 1024):
                plan = cluster_plan(E, K, rows, P, cluster)
                assert plan.cluster == cluster
                assert plan.cols % 4 == 0
                # CTA r owns [r*cols, min(K, r*cols + cols)): contiguous
                # slices from 0 to K, empty past K
                end = 0
                for r in range(cluster):
                    lo, hi = r * plan.cols, min(K, (r + 1) * plan.cols)
                    if lo < K:
                        assert lo == end and hi > lo
                        end = hi
                    else:
                        assert hi <= lo
                assert end == K
                assert 0 < plan.smem_bytes <= sweep_cuda.SMEM_PER_CTA
                assert 0 <= plan.depth <= sweep_cuda.RING_MAX


def test_main_path_plans_keep_the_sweep_on_chip():
    # N=1000/K=20000 at 8 rows a step: r, y, mask and est on chip and two
    # steps of rows in flight; at one row a step, the full ring
    main = cluster_plan(1, 20000, 8, 3)
    assert (main.cluster, main.cols, main.on_chip, main.depth) == (
        16, 1252, True, 2)
    row = cluster_plan(4, 15000, 1, 3)
    assert row.on_chip and row.depth == sweep_cuda.RING_MAX
    # a slice too wide for shared memory keeps r and est in device memory
    wide = cluster_plan(1, 10 ** 6, 8, 3)
    assert not wide.on_chip and wide.depth == 0
    # 1..32 rows a step, as the pinned sweep_block_size allows on CUDA
    with pytest.raises(ValueError, match="rows=33"):
        cluster_plan(1, 100, 33)


def test_map2000_plan_runs_without_the_ring():
    # N=2000/K=40000 at 8 rows a step: r, y, mask and est of 2,500
    # columns stay on chip and leave no room for one slot of the ring,
    # so no step's rows are prefetched; 250 block steps a launch
    plan = cluster_plan(1, 40000, 8, 3)
    assert (plan.cluster, plan.cols, plan.on_chip, plan.depth) == (
        16, 2500, True, 0)
    assert plan.smem_bytes + 4 * 2 * 8 * plan.cols > sweep_cuda.SMEM_PER_CTA
    assert cluster_plan(1, 30000, 8, 3).depth == 1


class _Kernel:
    """The kernels' library with the sweep's entry point stubbed: it
    records its arguments and reports success."""

    def __init__(self):
        self.calls = []

    def cm_sweep_cluster_f32(self, *args):
        self.calls.append(args)
        return 0


def _launch_stubbed(monkeypatch, N, K, rows, counter):
    """launch_cluster_sweep on CPU tensors against the stub, at 16 CTAs;
    returns the stub's calls."""
    lib = _Kernel()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(sweep_cuda, "_cluster_admitted", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    g = torch.Generator().manual_seed(0)
    stim = (torch.rand((1, N, K), generator=g) < 0.005) * 55.0
    lam = torch.rand((1, N, K), generator=g) * (stim > 0)
    powers = torch.tensor([45.0, 55.0, 65.0])
    counts = torch.stack([(stim == p).sum(-1) for p in powers], -1).float()
    vec = torch.rand((1, N), generator=g)
    steps = torch.arange(-(-N // rows))[None]
    sweep_cuda.launch_cluster_sweep(
        rows, torch.rand((1, K), generator=g), stim, vec, vec, lam, 0.1, vec,
        vec, torch.ones((1, K)), powers, counts, steps, 0.3, 3.0, 1.0,
        counter)
    return lib.calls


def test_each_launch_counts_its_plan_and_reset_clears_it(monkeypatch):
    # the counter on a wrapper of its own, so the module's counts stay
    def wrapper():
        pass

    reset_launches(wrapper)
    assert (wrapper.launches, wrapper.launches_f64, wrapper.plans) == (
        0, 0, {})
    for _ in range(3):
        (args,) = _launch_stubbed(monkeypatch, 2000, 400, 8, wrapper)
    plan = cluster_plan(1, 400, 8, 3)
    # N=2000 at 8 rows a step: 250 dependent block steps, the kernel's
    # nsteps argument (after E, N, K and P)
    want = SweepLaunch(16, plan.cols, plan.on_chip, plan.depth, 250)
    assert wrapper.plans == {want: 3}
    assert args[16:21] == (1, 2000, 400, 3, 250)
    _launch_stubbed(monkeypatch, 29, 301, 1, wrapper)
    assert wrapper.plans[SweepLaunch(*cluster_plan(1, 301, 1, 3)[:4],
                                     29)] == 1
    count_plan(wrapper, want)
    assert wrapper.plans[want] == 4
    reset_launches(wrapper)
    assert wrapper.plans == {} and wrapper.launches == 0


def test_every_sweep_wrapper_carries_a_plan_count():
    # the benchmark reads the blocked wrapper's; each wrapper passes
    # itself to launch_cluster_sweep as the counter
    from circuitmap_torch.ops import sweep_row_cuda

    for fn in (sweep_cuda.sweep_spikes_blocked,
               sweep_cuda.sweep_spikes_blocked_batched,
               sweep_row_cuda.sweep_spikes_row,
               sweep_row_cuda.sweep_spikes_row_batched):
        assert isinstance(fn.plans, dict)


@pytest.mark.parametrize("rows", [7, 12, 16, 32])
def test_pinned_block_plans_at_the_main_path_width(rows):
    # N=1000/K=20000, P=3: r, y, mask and est stay on chip; the ring
    # shrinks as the rows grow
    plan = cluster_plan(1, 20000, rows, 3)
    assert plan.cols == 1252 and plan.smem_bytes <= sweep_cuda.SMEM_PER_CTA
    assert plan.on_chip and plan.depth == (2 if rows < 12 else
                                           1 if rows == 12 else 0)
    # 16 levels: the exchange and the reduction grow with rows * 17; at
    # 32 rows (~105 KB of them) r and est leave shared memory
    wide = cluster_plan(1, 20000, rows, 16)
    assert wide.smem_bytes >= 4 * (2 * 16 + 16) * rows * 17
    assert wide.smem_bytes <= sweep_cuda.SMEM_PER_CTA
    assert wide.on_chip == (rows < 32)


@pytest.mark.parametrize("P", [17, 24, 64, 1024])
def test_plans_above_the_compile_time_levels(P):
    # above 16 levels the partials go to global scratch: shared memory
    # holds one pass's reduction and no [P]-long row parameters, so the
    # layout does not grow with P and the main path's width stays on chip
    for rows in (1, 8, 32):
        plan = cluster_plan(1, 20000, rows, P)
        assert plan == cluster_plan(1, 20000, rows, 17)
        assert plan.on_chip and plan.smem_bytes <= sweep_cuda.SMEM_PER_CTA


def _largest_on_chip_k(rows, P, item):
    lo, hi = 4, 2_000_000
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if cluster_plan(1, mid, rows, P, 16, item).on_chip:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_float64_plan_halves_the_on_chip_limit(rows):
    # in float64 (8-byte elements) the kernel's layout is always the
    # runtime-level one; against float32 in that layout (24 levels), the
    # largest K whose slice stays on chip is about half (the fixed parts
    # do not halve), and the float32 limit at the main path's 3 levels
    # stays where it was
    k4, k8 = (_largest_on_chip_k(rows, 24, item) for item in (4, 8))
    assert 0.49 < k8 / k4 <= 0.5
    assert _largest_on_chip_k(rows, 3, 8) == k8
    assert _largest_on_chip_k(1, 3, 4) == 231424
    plan = cluster_plan(1, k8, rows, 3, 16, 8)
    assert plan.on_chip and plan.smem_bytes <= sweep_cuda.SMEM_PER_CTA
    assert not cluster_plan(1, k8 + 1, rows, 3, 16, 8).on_chip


def test_float64_plans_at_the_main_path_width():
    # N=1000/K=20000 in float64: on chip at 8 rows and at one row; the
    # K=60000 sweep of the float64 off-chip check is not
    assert cluster_plan(1, 20000, 8, 3, 16, 8).on_chip
    assert cluster_plan(4, 15000, 1, 3, 16, 8).on_chip
    assert not cluster_plan(1, 60000, 8, 3, 16, 8).on_chip
    assert sweep_cuda.dynamic_levels(3, 8) and not sweep_cuda.dynamic_levels(3)
    with pytest.raises(ValueError, match="2-byte"):
        cluster_plan(1, 100, 8, 3, 16, 2)
