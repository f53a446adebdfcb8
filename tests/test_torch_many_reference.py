"""The port's batched ``caviar_many`` against the benchmark's plain
reference (``benchmarks/cmbench/reference.py``, plain PyTorch that
imports nothing of the port), fold by fold.

Four cross-validation folds of one seeded experiment (N=40, 400 trials
from the benchmark's own data generator; fold f holds out the f-th
contiguous quarter) are fit in one batched call at one row a sweep step,
with a fixed row order and exact power-curve means, in float64; the
reference fits each fold's charges alone in float64. Each field's gap is
its widest difference over the reference's largest magnitude (absolute
for the spike posteriors, which lie in [0, 1]). The two sides compute
the same algebra in other orders (batched Cholesky and products against
one fold's, the kernels' plain versions against the reference's own
sweep and Newton steps), so they differ by float64 rounding carried
through 10 iterations: measured at most 1.3e-10 (mu), 6.5e-12 (beta),
6.0e-10 (lam), 3.9e-9 (phi, phi_cov: the Newton refit's steps
magnify it), 1.3e-11 (z) and 5.1e-11 (rate). The same call in float32
reads 5.5e-7 to 3.4e-6 (mu), 3.8e-6 to 1.3e-5 (lam) and 1.3e-7 to
2.9e-5 (phi): each tolerance sits between the two, and a float32 fit
fails them (the last test).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import circuitmap_torch as cm

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "benchmarks"))
from cmbench import check, datagen  # noqa: E402
from cmbench import reference as R  # noqa: E402
from cmbench.counts_many import fold_keeps  # noqa: E402

FOLDS, N, TRIALS = 4, 40, 400
# (tolerance, absolute): 8-12x above float64's largest gap, at least 4x
# below float32's smallest in mu and lam, 2.6x in phi
TOL = {"mu": (1e-9, False), "beta": (1e-10, False), "lam": (1e-8, True),
       "phi": (5e-8, False), "phi_cov": (5e-8, False), "z": (1e-10, False),
       "rate": (1e-9, False), "shape": (0.0, False)}


@pytest.fixture(scope="module")
def expt():
    cfg = json.loads((REPO / "benchmarks" / "configs"
                      / "map1000cv4.json").read_text())
    cfg.update(N=N, trials=TRIALS)
    cfg["fit"]["iters"] = 10
    d = datagen.make_experiment(cfg, 2**31 + 77, "cpu")
    psc, stim = d["psc"].double(), d["stim"].double()
    assert cfg["folds"] == FOLDS
    return cfg, psc, stim, fold_keeps(cfg)


def _many(expt, dtype):
    cfg, psc, stim, keeps = expt
    fit = dict(cfg["fit"])
    fit.pop("method")
    assert (fit["compile_mode"], fit["sweep_block_size"]) == ("batched", 1)
    p = cm.default_priors(N)
    return cm.caviar_many(
        np.stack([psc.numpy()[k] for k in keeps]),
        np.stack([stim.numpy()[:, k] for k in keeps]),
        p["mu"], p["beta"], p["shape"], p["rate"], p["phi"], p["phi_cov"],
        powers=cfg["powers"], dtype=dtype, device="cpu", verbose=False,
        **fit)


@pytest.fixture(scope="module")
def many64(expt):
    return _many(expt, torch.float64)


@pytest.fixture(scope="module")
def refs(expt):
    cfg, psc, stim, keeps = expt
    out = []
    for keep in keeps:
        k = torch.as_tensor(keep)
        y, mask = R.charges(psc[k], cfg["fit"]["y_xcorr_thresh"])
        out.append(R.caviar(y, stim[:, k], mask, cfg["powers"], cfg["fit"],
                            torch.float64, "cpu"))
    return out


def _gaps(got, ref):
    return {f: check.gap(got[f], ref[f], absolute=a)
            for f, (_, a) in TOL.items()}


@pytest.mark.parametrize("fold", range(FOLDS))
def test_each_fold_matches_the_plain_reference(many64, refs, fold):
    got, ref = many64[fold], refs[fold]
    assert got["lam"].shape == (N, TRIALS - TRIALS // FOLDS)
    assert 0 < int(np.sum(ref["mu"].numpy() != 0)) < N
    gaps = _gaps(got, ref)
    bad = {f: g for f, g in gaps.items() if g > TOL[f][0]}
    assert not bad, gaps


def test_a_float32_fit_fails_the_tolerances(expt, refs):
    many32 = _many(expt, torch.float32)
    for got, ref in zip(many32, refs):
        gaps = _gaps(got, ref)
        assert gaps["mu"] > TOL["mu"][0] and gaps["lam"] > TOL["lam"][0]
