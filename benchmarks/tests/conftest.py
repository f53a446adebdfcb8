"""The benchmark's own tests: ``python -m pytest benchmarks/tests -q``
from the root of the repository. Tests marked ``cuda`` need the card
and skip elsewhere, decided inside the ``cuda`` fixture."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "benchmarks")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


CPU_LIMIT_FLOOR = 1e-4


def tiny_spec(cell):
    """The cell's spec at a size a CPU test holds: N=40, 400 trials,
    10 iterations (at 5 the fit has not settled: some connected neurons
    still hold the priors' power curves on both sides, and a median over
    the neurons cannot see a fault). Its limits are the cell's, raised to
    ``CPU_LIMIT_FLOOR`` where lower: on the CPU the program runs its
    plain versions, the Laplace refit in float32 where the card's kernel
    computes in double. Every fault below reads 1e-3 or more."""
    from cmbench import harness

    spec = harness.Spec(ROOT, cell)
    spec.limits = {k: max(v, CPU_LIMIT_FLOOR) for k, v in spec.limits.items()}
    spec.config.update(N=40, trials=400)
    spec.config["fit"]["iters"] = 10
    return spec
