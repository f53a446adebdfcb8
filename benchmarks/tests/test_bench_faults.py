"""A run whose timed path is broken underneath must come out not
correct: the harness's whole path but the look for a card, at a tiny
size on the CPU, once for each fault a cell can have. One card has no
exchange between chips, so that fault has no case here."""

import time

import numpy as np
import pytest
import torch
from conftest import tiny_spec

from circuitmap_torch import Model
from circuitmap_torch.demix.demixer import NeuralDemixer
from cmbench import harness

MAP_CELLS = ["map1000.demix_fit", "map1000.fit", "map1000.served"]


def _run(cell):
    res = harness.run_cell(tiny_spec(cell), 2**31 + 23, 0.2, 0, "cpu",
                           time.perf_counter(), log=lambda s: None)
    return res["correct"], res["lines"]


def _wrap_fit(monkeypatch, before=None, after=None):
    real = Model.fit

    def fit(self, obs, stimuli, method="caviar", fit_options=None, **kw):
        fit_options = dict(fit_options or {})
        if before is not None:
            obs, fit_options = before(obs, fit_options)
        out = real(self, obs, stimuli, method, fit_options, **kw)
        if after is not None:
            after(self)
        return out

    monkeypatch.setattr(Model, "fit", fit)


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_sound_run_is_correct(cell):
    ok, lines = _run(cell)
    assert ok, lines


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_state_returned_unchanged(cell, monkeypatch):
    # the fit's loop runs no iteration: its state is the priors'
    _wrap_fit(monkeypatch,
              before=lambda obs, o: (obs, dict(o, iters=0)))
    assert not _run(cell)[0]


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_half_the_trials_left_out(cell, monkeypatch):
    def drop(obs, o):
        obs = torch.as_tensor(np.asarray(obs)).clone() \
            if not isinstance(obs, torch.Tensor) else obs.clone()
        obs[obs.shape[0] // 2:] = 0.0
        return obs, o

    _wrap_fit(monkeypatch, before=drop)
    assert not _run(cell)[0]


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    # the map's power curves, off by 1% (the compared numbers are
    # medians over the neurons: one neuron's answer is not what they see)
    def alter(model):
        model.state["phi"] = np.array(model.state["phi"]) * 1.01

    _wrap_fit(monkeypatch, after=alter)
    assert not _run(cell)[0]


def test_demixed_trace_altered_where_produced(monkeypatch):
    real = NeuralDemixer.__call__

    def call(self, traces, *a, **kw):
        out = real(self, traces, *a, **kw)
        out = out.clone()
        k = int(torch.argmax(out.abs().amax(1)))
        out[k] *= 1.01
        return out

    monkeypatch.setattr(NeuralDemixer, "__call__", call)
    assert not _run("map1000.demix_fit")[0]
