"""CAVI-SnS on the main path's map: the port against the JAX package.

Three steps on the same numbers:

1. ``orders`` (the JAX package, on the CPU) writes the row orders that
   the JAX package's CAVI-SnS draws at seeds 1-8: each iteration splits
   its key and permutes the rows with each of the first three parts.
2. ``card`` (PyTorch only, needs an NVIDIA GPU) simulates the main
   path's map (``bench.py``'s N=1000, K=20000, H=10,
   ``np.random.seed(0)``), demixes it on the int4d2 wire, and fits the
   port's CAVI-SnS through ``Model.fit``, 50 iterations each:
   - on the card in float32 with its defaults (random order, 100 Monte
     Carlo samples) at seeds 1-8;
   - on the card in float32 with the power-curve means exact
     (``analytic_mc``) and the JAX package's row orders of step 1 in
     place of ``torch.randperm``'s;
   - on the host in float64 with the row order fixed
     (``update_order="identity"``) and ``analytic_mc``, a fit that draws
     nothing.
   It writes what CAVI-SnS reads of the traces, their trapezoidal
   charges, with the stim, the true weights and the fits to an npz.
3. ``jax`` (the JAX package, on the CPU) reads that npz and fits the
   same charges: float32 and float64 with the defaults at seeds 1-8,
   float32 with ``analytic_mc`` at seeds 1-8 (the fits the card drove
   with these orders), and the float64 fixed-order fit, each held
   against the port's.

A trace pair ``[c, c]`` has the trapezoidal charge ``c`` exactly, so
both packages fit the charges the card computed.

    JAX_PLATFORMS=cpu python3 sns_reference.py orders _scratch/sns_orders.npz
    python3 sns_reference.py card _scratch/sns_orders.npz chiprun_out/sns_reference.npz
    JAX_PLATFORMS=cpu python3 sns_reference.py jax chiprun_out/sns_reference.npz
"""

import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N, K, H, ITERS, SEEDS = 1000, 20000, 10, 50, tuple(range(1, 9))
CHECKPOINT = HERE / "demixers" / "nwd_ie_ChroME2f_int4d2qat.npz"
FIXED = {"update_order": "identity", "analytic_mc": True}
STATE = ("mu", "alpha", "beta", "phi")


def r2(w, est):
    w, est = np.asarray(w, float), np.asarray(est, float)
    return 1.0 - np.sum((w - est) ** 2) / np.sum((w - w.mean()) ** 2)


def report(name, state, w, seconds):
    """Print one fit's truth-R2; returns that of mu*alpha."""
    mu, alpha = np.asarray(state["mu"]), np.asarray(state["alpha"])
    score = r2(w, mu * alpha)
    print(f"{name}: truth-R2 of mu*alpha {score:.4f}, of mu "
          f"{r2(w, mu):.4f}; {int((alpha > 0.5).sum())} cells at alpha > 0.5"
          f"; {seconds:.1f} s", flush=True)
    return score


def summary(name, scores):
    print(f"{name}, seeds {SEEDS[0]}-{SEEDS[-1]}: truth-R2 of mu*alpha mean "
          f"{np.mean(scores):.4f}, from {min(scores):.4f} to "
          f"{max(scores):.4f}", flush=True)


def largest_difference(name, got, want):
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    print(f"{name}: largest difference {rel:.3e} of the largest value")


def jax_orders(out):
    import jax

    orders = np.empty((len(SEEDS), ITERS, 3, N), np.int16)
    for i, seed in enumerate(SEEDS):
        key = jax.random.PRNGKey(seed)
        for t in range(ITERS):
            key, *parts = jax.random.split(key, 5)
            for s in range(3):
                orders[i, t, s] = np.asarray(
                    jax.random.permutation(parts[s], N))
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, orders=orders)
    print(f"wrote {out}")


def card(orders_path, out):
    import torch
    from circuitmap_torch import Model, NeuralDemixer, simulate
    from circuitmap_torch.ops.charge import integrated_charge

    orders = np.load(orders_path)["orders"]
    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=H, connection_prob=0.05,
                   batch_size=1000, verbose=False)
    dem = NeuralDemixer(str(CHECKPOINT))(
        sim["psc"], keep_on_device=True, transfer_dtype="int4d2",
        verbose=False)
    charge = integrated_charge(dem)
    pair = torch.stack([charge, charge], 1)
    if not torch.equal(integrated_charge(pair), charge):
        raise AssertionError("a trace pair [c, c] must integrate to c")
    stim, w = np.asarray(sim["stim_matrix"]), np.asarray(sim["weights"])

    def fit(obs, device=None, **opts):
        t0 = time.time()
        m = Model(N).fit(obs, stim, method="cavi_sns", device=device,
                         fit_options={"iters": ITERS, "save_histories": False,
                                      "verbose": False, **opts})
        torch.cuda.synchronize()
        return m.state, time.time() - t0

    saved, scores = {}, []
    for seed in SEEDS:
        state, s = fit(dem, seed=seed)
        scores.append(report(f"port, card, float32, seed {seed}", state, w, s))
        if seed == SEEDS[0]:
            first = state
    summary("port, card, float32", scores)
    same, _ = fit(pair, seed=SEEDS[0])
    if not all(np.array_equal(same[key], first[key])
               for key in ("mu", "alpha", "lam")):
        raise AssertionError("the trace pair must fit as the traces do")
    print("the trace pair fits as the demixed traces do (bit for bit)")

    real_randperm = torch.randperm
    for i, seed in enumerate(SEEDS):
        queue = [torch.from_numpy(o.astype(np.int64))
                 for o in orders[i].reshape(-1, N)]

        def jax_randperm(n, generator=None, device=None):
            assert n == N
            return queue.pop(0).to(device)

        torch.randperm = jax_randperm
        try:
            state, s = fit(dem, seed=seed, analytic_mc=True)
        finally:
            torch.randperm = real_randperm
        if queue:
            raise AssertionError(f"{len(queue)} row orders left unused")
        report(f"port, card, float32, exact means, JAX's orders of seed "
               f"{seed}", state, w, s)
        for key in STATE:
            saved[f"orders{seed}_{key}"] = state[key]

    state, s = fit(np.stack([charge.cpu().numpy()] * 2, 1).astype(np.float64),
                   device="cpu", dtype="float64", **FIXED)
    report("port, host, float64, fixed order", state, w, s)
    saved.update({f"fixed_{key}": state[key] for key in STATE})
    n, k = np.nonzero(stim)
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, charge=charge.cpu().numpy(), weights=w, stim_n=n,
             stim_k=k, stim_v=stim[n, k], **saved)
    print(f"wrote {out}")


def jax_reference(path):
    import jax
    import jax.numpy as jnp
    from circuitmap_tpu.model import Model

    d = np.load(path)
    stim = np.zeros((N, K))
    stim[d["stim_n"], d["stim_k"]] = d["stim_v"]
    w = d["weights"]
    pair = np.stack([d["charge"]] * 2, 1)

    def fit(dtype, **opts):
        t0 = time.time()
        m = Model(N)
        m.fit(pair, stim, method="cavi_sns", fit_options={
            "iters": ITERS, "save_histories": False, "verbose": False,
            "dtype": dtype, **opts})
        return m.state, time.time() - t0

    for seed in SEEDS:
        state, s = fit(jnp.float32, seed=seed, analytic_mc=True)
        report(f"JAX, CPU, float32, exact means, seed {seed}", state, w, s)
        for key in ("mu", "alpha"):
            largest_difference(f"  the card's fit on these orders, {key}",
                               d[f"orders{seed}_{key}"], np.asarray(state[key]))
    for bits, dtype in ((32, jnp.float32), (64, jnp.float64)):
        if bits == 64:
            jax.config.update("jax_enable_x64", True)
        scores = []
        for seed in SEEDS:
            state, s = fit(dtype, seed=seed)
            scores.append(report(f"JAX, CPU, float{bits}, seed {seed}",
                                 state, w, s))
        summary(f"JAX, CPU, float{bits}", scores)
    state, s = fit(jnp.float64, **FIXED)
    report("JAX, CPU, float64, fixed order", state, w, s)
    for key in STATE:
        largest_difference(f"fixed order, port against JAX, {key}",
                           d[f"fixed_{key}"], np.asarray(state[key]))


def main():
    steps = {"orders": (jax_orders, 1), "card": (card, 2),
             "jax": (jax_reference, 1)}
    step = steps.get(sys.argv[1] if len(sys.argv) > 1 else None)
    if step is None or len(sys.argv) != 2 + step[1]:
        print(__doc__, file=sys.stderr)
        return 2
    step[0](*sys.argv[2:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
