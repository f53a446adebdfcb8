"""The readers of the program's count of B1 launches by plan
(``sweep.ring_depth``, ``sweep.step_us``) on hand-made slices and
counts, with None where the program keeps no such count (as before it
existed) or launched no B1."""

import pytest

from circuitmap_torch.ops import sweep_cuda
from cmbench import harness
from cmbench.trace import Trace

KERNEL = "void cm_sweep::detail::sweep_cluster_kernel<float, 8, 3>"
MAP2000 = sweep_cuda.SweepLaunch(16, 2500, True, 0, 250)
MAP1000 = sweep_cuda.SweepLaunch(16, 1252, True, 2, 125)


def ctx(ops=(), launches=None):
    return harness.Context(trace=Trace(list(ops), [], 0.0, 1e6),
                           launches={"sweep_blocked": 0, "laplace": 0,
                                     **(launches or {})})


@pytest.fixture
def plans(monkeypatch):
    """The blocked sweep's count of launches by plan, set by the test."""
    box = {}
    monkeypatch.setattr(sweep_cuda.sweep_spikes_blocked, "plans", box)
    return box


# two B1 launches in the slice, 5 ms each, and other device work
OPS = [(KERNEL, 0.0, 5000.0), ("Memcpy DtoH (Device -> Pageable)",
                               5000.0, 9000.0), (KERNEL, 10000.0, 15000.0)]


def test_ring_depth_is_the_plan_most_launches_took(plans):
    # a few launches at another width (say a shorter fit) do not decide
    plans.update({MAP2000: 100, MAP1000: 3})
    assert harness.reader("sweep.ring_depth")(ctx()) == 0
    plans.update({MAP1000: 150})
    assert harness.reader("sweep.ring_depth")(ctx()) == 2


def test_step_us_is_the_kernels_time_a_launch_over_its_steps(plans):
    plans.update({MAP2000: 100})
    got = harness.reader("sweep.step_us")(ctx(OPS, {"sweep_blocked": 2}))
    assert got == pytest.approx(5000.0 / 250)
    plans.clear()
    plans.update({MAP1000: 100})
    got = harness.reader("sweep.step_us")(ctx(OPS, {"sweep_blocked": 2}))
    assert got == pytest.approx(5000.0 / 125)


@pytest.mark.parametrize("name", ["sweep.ring_depth", "sweep.step_us"])
def test_a_program_without_the_count_gives_none(name, monkeypatch):
    monkeypatch.delattr(sweep_cuda.sweep_spikes_blocked, "plans")
    assert harness.reader(name)(ctx(OPS, {"sweep_blocked": 2})) is None


@pytest.mark.parametrize("name", ["sweep.ring_depth", "sweep.step_us"])
def test_a_run_without_b1_launches_gives_none(name, plans):
    assert harness.reader(name)(ctx()) is None


def test_step_us_needs_the_slices_launches_and_kernel(plans):
    plans.update({MAP2000: 100})
    read = harness.reader("sweep.step_us")
    assert read(ctx(OPS)) is None                          # none counted
    assert read(ctx(OPS[1:2], {"sweep_blocked": 2})) is None  # none traced
