"""The cross-validated 1,000-candidate map: its configuration is map1000's
with four folds fit in one batched ``caviar_many`` call, the bytes of
its batched row sweep are counted by hand, and its cell runs the
harness's whole path (a tiny run on the CPU, the program against the
reference fold by fold on seeded data) to the result line's keys."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import ROOT, tiny_spec

from cmbench import check, counts_many, harness

# the keys that describe a configuration rather than set it
DESCRIPTIVE = {"name", "source", "deployment", "assumed"}
CELL = "map1000cv4.fit_many"


def _config(name):
    with open(os.path.join(ROOT, "benchmarks", "configs",
                           name + ".json")) as fh:
        return json.load(fh)


def test_map1000cv4_is_map1000_in_four_batched_folds():
    base, cv = _config("map1000"), _config("map1000cv4")
    assert set(cv) == set(base) | {"folds"}
    differ = {k for k in base if base[k] != cv[k]}
    assert differ - DESCRIPTIVE == {"fit"}
    assert cv["folds"] == 4
    fit = dict(cv["fit"])
    assert fit.pop("compile_mode") == "batched"
    # what "auto" resolves to in caviar_many's batched mode
    assert fit.pop("sweep_block_size") == 1
    base_fit = dict(base["fit"])
    base_fit.pop("sweep_block_size")
    assert fit == base_fit
    assert (fit["update_order"], fit["analytic_mc"]) == ("identity", True)
    # stimulations per neuron in a fold, H * K / N: 150, above SCALING.md's
    # ~100 floor
    assert cv["H"] * counts_many.fold_trials(cv) / cv["N"] == 150.0
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    entry = next(c for c in bench["configs"] if c["name"] == "map1000cv4")
    assert entry["file"] == "benchmarks/configs/map1000cv4.json"
    assert entry["reduced"] == [] and entry["source"] == cv["source"]
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "map1000cv4", "fit_many", 1)


def test_folds_hold_out_contiguous_quarters():
    # one rule cuts the folds, for the kind, its metric and the tests
    assert harness.kind({"request": "many"}).fold_keeps is \
        counts_many.fold_keeps
    keeps = counts_many.fold_keeps({"trials": 20000, "folds": 4})
    assert [k.size for k in keeps] == [15000] * 4
    for f, keep in enumerate(keeps):
        out = np.setdiff1d(np.arange(20000), keep)
        np.testing.assert_array_equal(out, np.arange(5000 * f,
                                                     5000 * (f + 1)))
        assert np.all(np.diff(keep) > 0)
    with pytest.raises(ValueError):
        counts_many.fold_keeps({"trials": 10, "folds": 4})


def test_batched_sweep_bytes_by_hand():
    # per fold B1's count: stim, lam in, lam out [N, K]; charges and mask
    # [K]; weights, variances and the two power-curve means [N]; power
    # counts [N, P]; float32
    by_hand = 4 * 4 * (3 * 1000 * 15000 + 2 * 15000 + 4 * 1000 + 1000 * 3)
    assert counts_many.batched_sweep_bytes(4, 1000, 15000, 3) == by_hand
    assert by_hand == 720_592_000
    assert round(counts_many.batched_sweep_bound_s(4, 1000, 15000, 3)
                 * 1e3, 4) == 0.2151
    # PERF.md's B5 row: 0.2149 ms, the three [E, N, K] arrays alone
    assert round(4 * 3 * 1000 * 15000 * 4 / counts_many.PEAK_BYTES_PER_S
                 * 1e3, 4) == 0.2149
    assert counts_many.fold_trials({"trials": 20000, "folds": 4}) == 15000


def test_one_moved_fold_reads_in_the_worst_fold_numbers_alone():
    """A fold whose every field moved by 1e-3 moves only the
    ``*_worst_fold`` numbers, the largest over the folds; in two folds it
    moves the medians over the folds too. Both are compared."""
    kind = harness.kind({"request": "many"})
    rng = np.random.default_rng(7)
    fields = ("mu", "beta", "rate", "phi", "lam")
    ref = [{"mu": np.r_[rng.uniform(5, 30, 6), np.zeros(2)],
            "beta": rng.uniform(1, 2, 8), "rate": np.float64(0.5),
            "phi": rng.uniform(1, 5, (8, 2)),
            "lam": rng.uniform(0, 1, (8, 30))} for _ in range(4)]

    def numbers(moved):
        out = {k: [post[k] + (1e-3 if f in moved else 1e-9)
                   * rng.uniform(1, 2, np.shape(post[k]))
                   for f, post in enumerate(ref)] for k in fields}
        small = {k: v for k, v in out.items() if k != "lam"}
        return kind.numbers({}, {}, ref, [small], [out])

    calm, one, two = numbers(()), numbers((2,)), numbers((1, 2))
    for k in ("phi_med_gap", "lam_med_gap", "mu_med_gap"):
        assert calm[k] < 1e-8 and one[k] < 1e-8, k
        assert calm[k + "_worst_fold"] < 1e-8, k
        assert one[k + "_worst_fold"] > 1e-5 and two[k] > 1e-5, k
    limits = harness.Spec(ROOT, CELL).limits
    assert {"phi_med_gap_worst_fold", "lam_med_gap_worst_fold"} <= set(limits)
    # an answer with another number of folds reads as not correct
    short = {k: [post[k] for post in ref[:3]] for k in ("mu", "phi")}
    nums = kind.numbers({}, {}, ref, [short], [])
    assert all(nums[k] == float("inf") for k in limits)


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_fold_batched_reference_is_each_folds_own(seed):
    """``reference_folds.caviar_folds`` against ``reference.caviar`` fold
    by fold in float64 (N=40, four folds of 300 trials, 10 iterations):
    the same operations summed in other shapes; measured at most 1.5e-9
    in lam and 1.7e-8 in phi_cov (the Laplace refit's Newton steps
    magnify 1e-14 in lam after one iteration), against the limits' 1e-4
    floor on the CPU."""
    import torch

    from cmbench import datagen
    from cmbench import reference as R
    from cmbench import reference_folds as RF

    cfg = tiny_spec(CELL).config
    d = datagen.make_experiment(cfg, seed, "cpu")
    y, mask = R.charges(d["psc"].double(), cfg["fit"]["y_xcorr_thresh"])
    stim = d["stim"].double()
    keeps = [torch.as_tensor(k) for k in
             harness.kind({"request": "many"}).fold_keeps(cfg)]
    each = [R.caviar(y[k], stim[:, k], mask[k], cfg["powers"], cfg["fit"],
                     torch.float64, "cpu") for k in keeps]
    together = RF.caviar_folds(
        torch.stack([y[k] for k in keeps]),
        torch.stack([stim[:, k] for k in keeps]),
        torch.stack([mask[k] for k in keeps]), cfg["powers"], cfg["fit"],
        torch.float64, "cpu")
    for a, b in zip(together, each):
        assert set(a) == set(b)
        assert check.gap(a["lam"], b["lam"], absolute=True) < 1e-8
        for f in ("mu", "beta", "shape", "rate", "z"):
            assert check.gap(a[f], b[f]) < 1e-9, f
        for f in ("phi", "phi_cov"):
            assert check.gap(a[f], b[f]) < 1e-7, f
    with pytest.raises(ValueError):
        RF.caviar_folds(y[None], stim[None], mask[None], cfg["powers"],
                        dict(cfg["fit"], sweep_block_size=8), torch.float64,
                        "cpu")


def test_fold_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "from cmbench import counts_many, reference_folds; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('circuitmap_torch', 'circuitmap_tpu', "
            "'jax')))").format(ROOT, os.path.join(ROOT, "benchmarks"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_map1000cv4_run_is_correct(trace):
    spec = tiny_spec(CELL)
    res = harness.run_cell(spec, 2**31 + 1004, 0.2, trace, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert res["correct"], res["lines"]
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": 0}
    line = json.loads(json.dumps(harness.result_line(res, spec, device)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == set(spec.limits) == {
        "phi_med_gap", "lam_med_gap", "phi_med_gap_worst_fold",
        "lam_med_gap_worst_fold"}
    if trace:
        # the program's span is on the host; a CPU run has no CUDA events
        # and launches no B5
        assert "many.stim_ms" in line["metrics"]
        assert not {"many.ms", "many.sweep_roofline"} & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"setup_s", "map_s"}


# A run whose timed path is broken underneath must come out not correct:
# the harness's whole path at the tiny CPU size, with ``caviar_many``
# wrapped where the driver takes it. Each fault names what it does to
# the call (``before``: its stack and options) or to its answer
# (``after``: the list of folds' posteriors).


def _zero_half(stack, opts):
    stack = stack.clone()
    stack[:, stack.shape[1] // 2:] = 0.0
    return stack, opts


def _curves(folds):
    def alter(outs):
        for f in folds:
            outs[f]["phi"] = np.asarray(outs[f]["phi"]) * 1.01
        return outs
    return alter


def _fold_from(outs, f, other):
    outs[f] = {k: np.array(v, copy=True) for k, v in other[f].items()}
    return outs


FAULTS = {
    # every fold's loop runs no iteration: its state is the priors'
    "state_unchanged": dict(before=lambda s, o: (s, dict(o, iters=0))),
    "half_the_trials_left_out": dict(before=_zero_half),
    "every_folds_curves_altered": dict(after=_curves(range(4))),
    # one fold's answer is another fold's
    "one_fold_answered_by_another": dict(
        after=lambda outs: _fold_from(outs, 0, outs[1:] + outs[:1])),
    # the faults below move one fold alone: the medians over the folds
    # cannot see them, the largest over the folds does
    "one_folds_curves_altered": dict(after=_curves([2])),
    "one_fold_left_at_its_priors": dict(again=dict(iters=0), fold=1),
    "one_fold_fit_on_anothers_design": dict(roll=True, fold=3),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_fold_stack_reads_not_correct(fault, monkeypatch):
    import circuitmap_torch

    how = FAULTS[fault]
    real = circuitmap_torch.caviar_many

    def many(stack, stims, *priors, **opts):
        if "before" in how:
            stack, opts = how["before"](stack, opts)
        outs = real(stack, stims, *priors, **opts)
        if "after" in how:
            outs = how["after"](list(outs))
        if "again" in how:
            wrong = real(stack, stims, *priors, **dict(opts, **how["again"]))
            outs = _fold_from(list(outs), how["fold"], wrong)
        if how.get("roll"):
            wrong = real(stack, np.roll(stims, 1, axis=0), *priors, **opts)
            outs = _fold_from(list(outs), how["fold"], wrong)
        return outs

    monkeypatch.setattr(circuitmap_torch, "caviar_many", many)
    res = harness.run_cell(tiny_spec(CELL), 2**31 + 23, 0.2, 0, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert not res["correct"], res["lines"]
    if "fold" in how or fault == "one_folds_curves_altered":
        # seen by a fold's own reading alone
        failed = {ln.split()[0] for ln in res["lines"] if "FAILED" in ln}
        assert failed <= {"phi_med_gap_worst_fold",
                          "lam_med_gap_worst_fold"}, res["lines"]
