"""The port's multi-process trial-sharded fits
(``circuitmap_torch.parallel.distributed``) against its single-process
mesh.

Two processes, spawned with ``torch.multiprocessing``, join a gloo
process group on localhost; each holds two CPU shards and feeds its own
trials (uneven: 51 and 50), so the global mesh has four shards, as the
single-process ``trial_mesh(devices=["cpu"] * 4)`` it is held against.
float64 on both sides, identity row order and exact power-curve means:
the two layouts pad differently and sum in another grouping, so they
agree to rounding (1e-9 relative). Each spawned run has its own time
limit, so a hang fails the test instead of stalling the suite.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, K, SPLIT = 16, 101, 51
LIMIT_S = 120
FIELDS = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _data():
    from circuitmap_torch.model import default_priors
    from circuitmap_torch.simulation import simulate

    np.random.seed(3)
    sim = simulate(N=N, trials=K, H=3, connection_prob=0.25,
                   spont_prob=0.01, gp_scale=1e-3, verbose=False,
                   device="cpu")
    p = default_priors(N)
    priors = tuple(p[k] for k in ("mu", "beta", "shape", "rate", "phi",
                                  "phi_cov"))
    return np.asarray(sim["psc"]), np.asarray(sim["stim_matrix"]), priors


KW = dict(iters=3, seed=0, analytic_mc=True, update_order="identity",
          dtype=torch.float64, verbose=False)


def _worker(rank, port, psc, stim, priors, out_dir, entry, kw):
    from circuitmap_torch import parallel

    torch.set_num_threads(1)
    parallel.initialize_distributed(f"tcp://localhost:{port}", world_size=2,
                                    rank=rank, device="cpu")
    lo, hi = (0, SPLIT) if rank == 0 else (SPLIT, psc.shape[0])
    mesh = parallel.global_trial_mesh(devices=["cpu", "cpu"])
    fn = getattr(parallel, entry)
    if entry == "caviar_resumable_distributed":
        out = fn(psc[lo:hi], stim[:, lo:hi], *priors,
                 str(out_dir / "ck.npz"), mesh=mesh, **kw)
    else:
        out = fn(psc[lo:hi], stim[:, lo:hi], *priors, mesh=mesh, **kw)
    np.savez(out_dir / f"rank{rank}.npz",
             **{f: np.asarray(v) for f, v in zip(FIELDS, out[:8])},
             all_reduces=mesh.all_reduces)
    torch.distributed.destroy_process_group()


def _spawn(tmp_path, entry, kw, monkeypatch):
    psc, stim, priors = _data()
    # gloo's pairs on the loopback interface only
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.spawn(_worker, args=(_free_port(), psc, stim, priors, tmp_path,
                                  entry, kw), nprocs=2, join=False)
    deadline = time.time() + LIMIT_S
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"two-process {entry} did not finish in {LIMIT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]


def _single(entry_kw):
    from circuitmap_torch.parallel import caviar_sharded, trial_mesh

    psc, stim, priors = _data()
    out = caviar_sharded(psc, stim, *priors,
                         mesh=trial_mesh(devices=["cpu"] * 4), fn_scan=False,
                         **entry_kw)
    return {f: np.asarray(v) for f, v in zip(FIELDS, out[:8])}


def _assert_close(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=1e-9, atol=1e-12,
                                   err_msg=f)


def test_uneven_two_process_fit_matches_single_process_mesh(tmp_path,
                                                           monkeypatch):
    ranks = _spawn(tmp_path, "caviar_sharded_distributed", KW, monkeypatch)
    want = _single(KW)
    for r in ranks:  # gather_output: every rank holds the full posterior
        assert r["lam"].shape == (N, K)
        _assert_close(r, want)
        assert int(r["all_reduces"]) > 0


def test_two_process_resumable_matches_straight_run(tmp_path, monkeypatch):
    kw = dict(KW, iters=4, checkpoint_every=2)
    ranks = _spawn(tmp_path, "caviar_resumable_distributed", kw,
                   monkeypatch)
    want = _single(dict(KW, iters=4))
    _assert_close(ranks[1], want)
    from circuitmap_torch.utils.checkpoint import load_state

    ck = load_state(tmp_path / "ck.npz")
    assert int(ck["completed_iters"]) == 4
    np.testing.assert_array_equal(ck["lam"], ranks[0]["lam"])
