"""Two CAVIaR fits of the main path's map, the port against the JAX package.

Steps (the main path's map: ``bench.py``'s N=1000, K=20000, H=10,
``np.random.seed(0)``, demixed on the int4d2 wire by
``demixers/nwd_ie_ChroME2f_int4d2qat.npz``):

1. ``fold3-jax`` (the JAX package and the port, on the CPU): fold 3 of
   ``chip_smoke.py``'s phase 10 (the map without its last quarter of
   trials) at ``sweep_block_size=1``, simulated and demixed by the JAX
   package. The JAX package fits it at seeds 0-7 with its defaults; then,
   at seed 3, with its random streams fixed (exact power-curve means,
   ``analytic_mc``, float64), and the port's plain float64 fit runs on
   the JAX package's row orders (in place of ``torch.randperm``'s) and
   is held against it. Prints each fit's truth-R2 and cell 2's weight
   (w = 33.49).
2. ``fold3-card`` (PyTorch only, needs an NVIDIA GPU): the same fold,
   simulated and demixed by the port, fit by ``caviar_many``
   (sequential) at blocks 1 and 8 and seeds 0-7 on the card.
3. ``levels24-jax`` (both packages, on the CPU): the whole map with its
   stim re-levelled to 24 powers (``chip_smoke.relevelled``), fit at
   block 8 by the JAX package (seeds 0, 1) and by the port's plain
   version (seed 0), beside the same fits on the 3 simulated levels.

    JAX_PLATFORMS=cpu python3 reference_fits.py fold3-jax    # ~20 min
    python3 reference_fits.py fold3-card                     # ~1 min
    JAX_PLATFORMS=cpu python3 reference_fits.py levels24-jax # ~4 min
"""

import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N, K, H, ITERS, CELL = 1000, 20000, 10, 50, 2
CHECKPOINT = HERE / "demixers" / "nwd_ie_ChroME2f_int4d2qat.npz"
POWERS = [45.0, 55.0, 65.0]
FIELDS = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")


def r2(w, est):
    w, est = np.asarray(w, float), np.asarray(est, float)
    return 1.0 - np.sum((w - est) ** 2) / np.sum((w - w.mean()) ** 2)


def jax_map():
    """The map simulated and demixed by the JAX package (CPU)."""
    from circuitmap_tpu import simulate
    from circuitmap_tpu.demix.demixer import NeuralDemixer

    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=H, connection_prob=0.05,
                   batch_size=1000, verbose=False)
    dem = np.asarray(NeuralDemixer(path=str(CHECKPOINT))(
        sim["psc"], transfer_dtype="int4d2", verbose=False))
    return sim, dem


def fold3_jax():
    import jax
    import jax.numpy as jnp
    import torch
    from circuitmap_tpu.model import default_priors
    from circuitmap_tpu.solvers.caviar import caviar as jax_caviar
    from circuitmap_torch.solvers.caviar import caviar as port_caviar

    sim, dem = jax_map()
    w = sim["weights"]
    keep = np.r_[0:3 * K // 4]
    p = default_priors(N)
    args = (dem[keep], sim["stim_matrix"][:, keep], p["mu"], p["beta"],
            p["shape"], p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=ITERS, msrmp=0.3, powers=POWERS, verbose=False,
              sweep_block_size=1)
    for seed in range(8):
        t0 = time.time()
        mu = np.asarray(jax_caviar(*args, seed=seed, **kw)[0])
        print(f"JAX, float32, defaults, seed {seed}: truth-R2 "
              f"{r2(w, mu):.4f}, cell {CELL} at {mu[CELL]:.3f} "
              f"({time.time() - t0:.1f} s)", flush=True)
    seed = 3
    with jax.enable_x64(True):
        want = jax_caviar(*args, seed=seed, analytic_mc=True,
                          dtype=jnp.float64, **kw)
        want = [np.asarray(a) for a in want[:8]]
        key, orders = jax.random.PRNGKey(seed), []
        for _ in range(ITERS):
            key, k_order, _ = jax.random.split(key, 3)
            orders.append(np.array(jax.random.permutation(k_order, N)))
    print(f"JAX, float64, exact means, seed {seed}: truth-R2 "
          f"{r2(w, want[0]):.4f}, cell {CELL} at {want[0][CELL]:.3f}",
          flush=True)
    queue = [torch.as_tensor(o, dtype=torch.int64) for o in orders]
    real_randperm = torch.randperm
    torch.randperm = lambda n, generator=None, device=None: queue.pop(0)
    try:
        got = port_caviar(*args, seed=seed, analytic_mc=True,
                          dtype=torch.float64, device="cpu", **kw)
    finally:
        torch.randperm = real_randperm
    if queue:
        raise AssertionError(f"{len(queue)} row orders left unused")
    mu = np.asarray(got[0])
    print(f"port, plain float64, the JAX package's row orders: truth-R2 "
          f"{r2(w, mu):.4f}, cell {CELL} at {mu[CELL]:.3f}", flush=True)
    for name, a, b in zip(FIELDS, got, want):
        a, b = np.asarray(a, float), np.asarray(b, float)
        print(f"  {name}: max |port - JAX| / max |JAX| "
              f"{np.abs(a - b).max() / max(np.abs(b).max(), 1e-300):.3e}")


def fold3_card():
    import torch
    from circuitmap_torch import (NeuralDemixer, caviar_many, default_priors,
                                  simulate)

    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=H, connection_prob=0.05,
                   batch_size=1000, verbose=False)
    dem = NeuralDemixer(str(CHECKPOINT))(sim["psc"], keep_on_device=True,
                                         transfer_dtype="int4d2",
                                         verbose=False)
    keep = torch.arange(3 * K // 4, device=dem.device)
    y, stim = dem[keep][None], sim["stim_matrix"][:, :3 * K // 4][None]
    p = default_priors(N)
    args = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
            p["phi_cov"])
    w = sim["weights"]
    for block in (1, 8):
        for seed in range(8):
            (res,) = caviar_many(y, stim, *args, seeds=[seed],
                                 compile_mode="sequential",
                                 sweep_block_size=block, iters=ITERS,
                                 msrmp=0.3, powers=POWERS, verbose=False)
            print(f"port, card, block {block}, seed {seed}: truth-R2 "
                  f"{r2(w, res['mu']):.4f}, cell {CELL} at "
                  f"{res['mu'][CELL]:.3f}", flush=True)


def levels24_jax():
    from chip_smoke import relevelled
    from circuitmap_tpu.model import default_priors
    from circuitmap_tpu.solvers.caviar import caviar as jax_caviar
    from circuitmap_torch.solvers.caviar import caviar as port_caviar

    sim, dem = jax_map()
    w = sim["weights"]
    p = default_priors(N)
    for name, stim, extra in (("3 levels", sim["stim_matrix"],
                               {"powers": POWERS}),
                              ("24 levels", relevelled(sim["stim_matrix"]),
                               {})):
        args = (dem, stim, p["mu"], p["beta"], p["shape"], p["rate"],
                p["phi"], p["phi_cov"])
        kw = dict(iters=ITERS, msrmp=0.3, sweep_block_size=8,
                  verbose=False, **extra)
        for seed in (0, 1):
            mu = np.asarray(jax_caviar(*args, seed=seed, **kw)[0])
            print(f"JAX, {name}, block 8, seed {seed}: truth-R2 "
                  f"{r2(w, mu):.4f}", flush=True)
        mu = np.asarray(port_caviar(*args, seed=0, device="cpu", **kw)[0])
        print(f"port (plain, CPU), {name}, block 8, seed 0: truth-R2 "
              f"{r2(w, mu):.4f}", flush=True)


def main():
    steps = {"fold3-jax": fold3_jax, "fold3-card": fold3_card,
             "levels24-jax": levels24_jax}
    if len(sys.argv) != 2 or sys.argv[1] not in steps:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    steps[sys.argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
