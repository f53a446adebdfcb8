"""The reader of W1's device time an iteration (``gram.us``) on
hand-made slices, with None where no W1 operation ran (a program
without the kernel, or a Gram that took the dense product) or no B1
launch was counted."""

import pytest

from cmbench import harness
from cmbench.trace import Trace

W1 = "void cm_gram::costim_gram_kernel<float>(float const*, int const*)"
B1 = "void cm_sweep::detail::sweep_cluster_kernel<float, 8, 3>"
DENSE = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3"


def ctx(ops, sweeps):
    return harness.Context(trace=Trace(list(ops), [], 0.0, 1e6),
                           launches={"sweep_blocked": sweeps, "laplace": 0})


def test_gram_us_is_w1s_time_an_iteration():
    ops = [(W1, 0.0, 30.0), (B1, 30.0, 5000.0), (W1, 5000.0, 5034.0),
           (B1, 5034.0, 10000.0)]
    assert harness.reader("gram.us")(ctx(ops, 2)) == pytest.approx(32.0)


@pytest.mark.parametrize("ops,sweeps", [
    ([(DENSE, 0.0, 6400.0), (B1, 6400.0, 11000.0)], 1),  # the dense Gram
    ([(W1, 0.0, 30.0)], 0),                               # no B1 counted
    ([], 0),
])
def test_gram_us_without_w1_or_b1_gives_none(ops, sweeps):
    assert harness.reader("gram.us")(ctx(ops, sweeps)) is None
