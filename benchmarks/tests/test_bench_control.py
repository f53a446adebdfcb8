"""The control, on the card: the plain reference in float32 with TF32 on,
in the program's place, must come out not correct against the cell's
limits, at the cell's own size; the program on the same seed must come
out correct. Run on the card with ``python -m pytest
benchmarks/tests/test_bench_control.py -q`` (~1 minute a cell)."""

import pytest
from conftest import ROOT

from cmbench import check, harness
from cmbench.spans import Spans

CELLS = ["map1000.demix_fit", "map1000.fit"]


def _within(numbers, limits):
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, cuda):
    import torch

    spec = harness.Spec(ROOT, cell)
    cfg, traffic = spec.config, spec.traffic
    K = harness.kind(traffic)
    data = K.make_data(cfg, 2**31 + 101, cuda, ROOT)
    drv = K.Driver(cfg, traffic, data, cuda, ROOT, {})
    keeper = harness.Keeper(7, K.BIG)
    keeper.add(drv.request(Spans(False)))
    drv.close()
    del drv
    torch.cuda.empty_cache()
    ref = K.reference(cfg, traffic, data, cuda)
    program = harness.compare(spec, K.numbers(cfg, traffic, ref, keeper.small,
                                              keeper.sampled()))
    small, sampled = K.control(cfg, traffic, data, cuda)
    ctrl = harness.compare(spec, K.numbers(cfg, traffic, ref, small,
                                           sampled))
    assert _within(program, spec.limits), program
    assert not _within(ctrl, spec.limits), ctrl
    assert check.judge(ctrl, spec.limits, 1, 0)[0] is False
