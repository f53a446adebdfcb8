"""The cluster sweep's launch plan (``sweep_cuda.cluster_plan``), a plain
host function the CUDA kernel takes its layout from: the CTAs' column
slices cover exactly the K trials, each starts on a 16-byte boundary,
and no CTA asks for more shared memory than sm_90 gives one
(232,448 bytes)."""

import pytest

from circuitmap_torch.ops import sweep_cuda
from circuitmap_torch.ops.sweep_cuda import cluster_plan


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
