"""Helpers of the command-line parity tests (``tests/test_torch_cli_*.py``):
run a JAX script of ``scripts_tpu/`` in this process (the suite's CPU
JAX), run the same command of ``python -m circuitmap_torch`` on the CPU,
and compare what the two print and write.

Each side runs in a directory of its own (``jax/`` and ``port/`` under
the test's ``tmp_path``) with relative output paths, so the printed
lines name the same files.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts_tpu"
DEMIXER = str(REPO / "demixers" / "nwd_ie_ChroME2f.npz")
POWERS = [45.0, 55.0, 65.0]

_NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")


@pytest.fixture(autouse=True, scope="module")
def one_host_thread():
    """One torch and one BLAS thread while a file of these tests runs:
    the fits are tiny, and the suite runs in parallel workers, where a
    pool of threads per worker oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def sides(tmp_path):
    """The JAX and the port side's working directories."""
    out = []
    for name in ("jax", "port"):
        (tmp_path / name).mkdir(exist_ok=True)
        out.append(tmp_path / name)
    return out


def run_jax(name, argv, monkeypatch, cwd, capsys):
    """``scripts_tpu/<name>.py``'s ``main()`` with ``sys.argv`` set, in
    ``cwd``; returns what it printed."""
    capsys.readouterr()
    path = SCRIPTS / f"{name}.py"
    with monkeypatch.context() as m:
        m.chdir(cwd)
        m.syspath_prepend(str(SCRIPTS))  # train_qat_demixer's own import
        m.setattr(sys, "argv", [str(path), *map(str, argv)])
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        module.main()
    return capsys.readouterr().out


def run_port(command, argv, monkeypatch, cwd, capsys, device="cpu"):
    """``python -m circuitmap_torch <command> argv --device <device>`` in
    this process, in ``cwd``; returns what it printed."""
    from circuitmap_torch.__main__ import main

    capsys.readouterr()
    extra = [] if device is None else ["--device", device]
    with monkeypatch.context() as m:
        m.chdir(cwd)
        assert main([command, *map(str, argv), *extra]) == 0
    return capsys.readouterr().out


def summary(out, prefixes):
    """The lines of ``out`` that start with one of ``prefixes``, each
    number replaced by ``#``: the printed summary up to numbers."""
    return [_NUMBER.sub("#", line) for line in out.splitlines()
            if line.startswith(tuple(prefixes))]


def assert_same_arrays(got, want, exact=(), rtol=None):
    """The same keys, shapes and dtypes; the ``exact`` keys equal, the
    others within ``rtol`` when given."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        assert g.dtype == w.dtype, key
        if key in exact:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif rtol is not None:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)


def assert_connections_agree(mu_port, mu_jax, floor=0.9):
    """Precision and recall of each package's connection set (mu != 0)
    against the other's at ``floor`` or more."""
    from circuitmap_torch.utils.metrics import precision_recall_connections

    precision, recall = precision_recall_connections(mu_jax, mu_port)
    assert precision >= floor and recall >= floor, (precision, recall)
    assert np.count_nonzero(mu_jax) > 0


def assert_fit_equal(got, want, rtol=1e-6):
    """A command's posterior field against the in-process fit's."""
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))
