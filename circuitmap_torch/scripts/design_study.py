"""Design-policy study: adaptive closed-loop vs the static protocol
(port of ``scripts_tpu/design_study.py``).

Quantifies what the closed-loop subsystem (``AdaptiveDesigner`` +
``OnlineCaviar``) buys over the strictly offline workflow (stimulate
with a fixed design, record everything, fit afterwards). Both arms
spend the same per-round trial blocks and CAVI schedule; the adaptive
arm redraws each round's ensembles over the unresolved neuron pool and
STOPS when every neuron's status is evidence-resolved.

Writes DESIGN_STUDY.json: per-seed trial counts, recovery R²,
connection precision/recall at the point each arm stops, plus the
matched-budget comparison (adaptive vs static truncated to the same
trials). The simulation and the fits run on ``--device`` (the GPU by
default); ``--device cpu`` reproduces a CPU run.

  python -m circuitmap_torch design-study [--N 120 --block 360 --rounds 10
      --seeds 3 --out DESIGN_STUDY.json]
"""

import argparse
import json

import numpy as np

from . import add_device_argument

POWERS = [45.0, 55.0, 65.0]


def synth_block(truth, stim, device=None):
    """Trials for a chosen design over the fixed ground-truth circuit
    (simulate()'s closed-loop extension: stim_matrix= + weights=/phi=)."""
    from ..simulation import simulate

    return simulate(
        N=truth["weights"].size, stim_matrix=stim,
        weights=truth["weights"], phi_0=truth["phi_0"],
        phi_1=truth["phi_1"], kernel=(truth["tau_r"], truth["tau_d"]),
        powers=POWERS, verbose=False, device=device,
    )["psc"]


def run_arm(truth, designs, adaptive, H, iters_per_round=8,
            null_trials=18, conn_trials=30, device=None):
    """Stream rounds; returns per-round (trials, r2, precision, recall,
    unresolved). Round 0's design is shared so both arms start from
    identical data; the adaptive arm redraws later rounds over the
    unresolved pool and stops early at full resolution."""
    from ..design import AdaptiveDesigner
    from ..solvers.online import OnlineCaviar
    from ..utils.metrics import precision_recall_connections, r2_score

    N = truth["weights"].size
    oc = OnlineCaviar(N, powers=POWERS, device=device)
    designer = AdaptiveDesigner(N, H, POWERS, null_trials=null_trials,
                                conn_trials=conn_trials)
    history = []
    for r, stim in enumerate(designs):
        if adaptive and r > 0:
            stim = designer.next_design(stim.shape[1])
        psc = synth_block(truth, stim, device)
        oc.update(psc, stim, iters=iters_per_round)
        post = oc.posterior()
        designer.observe(stim, post)
        prec, rec = precision_recall_connections(truth["weights"],
                                                 post["mu"])
        history.append({
            "trials": int(oc.trial_count),
            "r2": float(r2_score(truth["weights"], post["mu"])),
            "precision": float(prec),
            "recall": float(rec),
            "unresolved": int(designer.pool.size),
        })
        if adaptive and designer.resolved:
            break
    return history


def main(argv=None):
    from ..simulation import blockwise_design, simulate

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch design-study", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--N", type=int, default=120)
    parser.add_argument("--H", type=int, default=5)
    parser.add_argument("--block", type=int, default=360)
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--seeds", type=int, default=3)
    parser.add_argument("--connection_prob", type=float, default=0.08)
    parser.add_argument("--out", default="DESIGN_STUDY.json")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    results = []
    for seed in range(args.seeds):
        np.random.seed(100 + seed)
        # one throwaway block draws the fixed circuit; its trials are
        # NOT given to either arm
        truth = simulate(N=args.N, trials=8, H=args.H, powers=POWERS,
                         connection_prob=args.connection_prob,
                         verbose=False, device=args.device)
        designs = [blockwise_design(args.N, args.H, args.block, POWERS)
                   for _ in range(args.rounds)]
        static = run_arm(truth, designs, adaptive=False, H=args.H,
                         device=args.device)
        adaptive = run_arm(truth, designs, adaptive=True, H=args.H,
                           device=args.device)
        # matched-budget point: the static trajectory at (or before)
        # the adaptive arm's stopping budget
        stop = adaptive[-1]["trials"]
        static_at_stop = max(
            (h for h in static if h["trials"] <= stop),
            key=lambda h: h["trials"])
        results.append({
            "seed": seed,
            "n_true_connections": int(
                np.count_nonzero(truth["weights"])),
            "adaptive_final": adaptive[-1],
            "static_at_matched_budget": static_at_stop,
            "static_full_budget": static[-1],
            "adaptive_rounds": len(adaptive),
            "static_rounds": len(static),
        })
        print(f"seed {seed}: adaptive resolved in "
              f"{adaptive[-1]['trials']} trials "
              f"(R2 {adaptive[-1]['r2']:.3f}, "
              f"recall {adaptive[-1]['recall']:.2f}) vs static "
              f"{static[-1]['trials']} trials "
              f"(R2 {static[-1]['r2']:.3f})")

    summary = {
        "protocol": {
            "N": args.N, "H": args.H, "block_trials": args.block,
            "max_rounds": args.rounds, "powers": POWERS,
            "connection_prob": args.connection_prob,
            "iters_per_round": 8,
            "comment": "static = the reference's fixed blockwise "
                       "design streamed block by block; adaptive = "
                       "AdaptiveDesigner pool narrowing with "
                       "evidence-count early stop; identical round-0 "
                       "data, same solver schedule",
        },
        "per_seed": results,
        "mean_adaptive_trials": float(np.mean(
            [r["adaptive_final"]["trials"] for r in results])),
        "mean_static_trials": float(np.mean(
            [r["static_full_budget"]["trials"] for r in results])),
        "mean_adaptive_r2": float(np.mean(
            [r["adaptive_final"]["r2"] for r in results])),
        "mean_static_full_r2": float(np.mean(
            [r["static_full_budget"]["r2"] for r in results])),
        "mean_r2_at_matched_budget_static": float(np.mean(
            [r["static_at_matched_budget"]["r2"] for r in results])),
    }
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"wrote {args.out}: adaptive "
          f"{summary['mean_adaptive_trials']:.0f} trials / R2 "
          f"{summary['mean_adaptive_r2']:.3f} vs static "
          f"{summary['mean_static_trials']:.0f} trials / R2 "
          f"{summary['mean_static_full_r2']:.3f} "
          f"(static at matched budget: R2 "
          f"{summary['mean_r2_at_matched_budget_static']:.3f})")
