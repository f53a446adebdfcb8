"""Multi-process CAVIaR fit worker (port of
``scripts_tpu/run_distributed_fit.py``).

One instance runs per process. Each process loads ONLY its own trial
shard and joins the others through
``circuitmap_torch.parallel.distributed.initialize`` — the per-process
feeding contract of ``caviar_sharded_distributed``: no process ever
holds the full trace block. Global trial order is rank order.

Devices: on CUDA each rank takes ``cuda:<local rank>`` and the ranks
join by NCCL when each has its own card; when there are more ranks on
a host than cards, ranks share cards and join by gloo.
``--cpu-devices N`` runs the rank on N CPU shards of its trials (gloo).

  python -m circuitmap_torch distributed-fit \
      --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 \
      --data shard0.npz --out out0.npz

Without ``--coordinator`` the process group comes from the environment
``torchrun`` sets. The data npz needs ``psc`` [K_local, T] and ``stim``
[N, K_local]. Writes mu/beta/lam/shape/rate/phi/phi_cov/z (full
gathered posteriors, identical on every process) and prints one JSON
line.
"""

import argparse
import json
import os

import numpy as np

WIRES = ("f32", "f16", "int8", "int4", "int4d2")


def rank_device(world, rank):
    """(device, backend) of this rank: ``cuda:<local rank>`` under NCCL
    when the host's ranks have a card each, and under gloo when they
    share cards."""
    import torch

    from .._device import resolve_device

    resolve_device(None)  # raises without a GPU
    count = torch.cuda.device_count()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if local_world <= count:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", local_rank % count), "gloo"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch distributed-fit",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu-devices", type=int, default=None,
                    help="run this process on that many CPU shards of "
                         "its trials (testing)")
    ap.add_argument("--data", required=True,
                    help="npz with psc [K_local,T] and stim [N,K_local]")
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--msrmp", type=float, default=0.3)
    ap.add_argument("--powers", type=float, nargs="*", default=None)
    ap.add_argument("--analytic-mc", action="store_true")
    ap.add_argument("--sweep-block-size", type=int, default=1)
    ap.add_argument("--trace-wire", default=None, choices=WIRES,
                    help="compress this process's trace upload "
                         "(solvers/_common.prepare_traces)")
    ap.add_argument("--solver", choices=("caviar", "sns", "mbcs"),
                    default="caviar")
    ap.add_argument("--demixer", default=None,
                    help="demix this process's raw trace shard first "
                         "(.npz/.ckpt checkpoint path); demixing is "
                         "row-independent, so each process demixes its "
                         "own shard on its own device")
    ap.add_argument("--demix-wire", default=None, choices=WIRES,
                    help="host->device transfer format for the demixer "
                         "upload (pair int4* with a QAT checkpoint)")
    ap.add_argument("--checkpoint", default=None,
                    help="segmented caviar fit with checkpoint/resume "
                         "(parallel.caviar_resumable_distributed); path "
                         "must be on a shared filesystem")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    args = ap.parse_args(argv)
    if args.checkpoint and args.solver != "caviar":
        ap.error("--checkpoint is only supported with --solver caviar")

    import torch

    from ..model import default_priors
    from ..parallel import distributed as dist

    world = args.num_processes
    rank = args.process_id
    if args.cpu_devices:
        device, backend = torch.device("cpu"), "gloo"
        devices = ["cpu"] * args.cpu_devices
    else:
        device, backend = rank_device(
            world or int(os.environ.get("WORLD_SIZE", 1)),
            rank if rank is not None else int(os.environ.get("RANK", 0)))
        devices = [device]
    dist.initialize(
        init_method=f"tcp://{args.coordinator}" if args.coordinator else None,
        world_size=world, rank=rank, backend=backend, device=device)
    try:
        mesh = dist.global_trial_mesh(devices=devices)
        verbose = mesh.rank == 0

        data = np.load(args.data)
        psc, stim = data["psc"], data["stim"]
        if args.demixer:
            from ..demix.demixer import NeuralDemixer

            demixer = NeuralDemixer(path=args.demixer, device=device)
            psc = demixer(psc, verbose=verbose,
                          transfer_dtype=args.demix_wire)
        N = stim.shape[0]
        p = default_priors(N)

        if args.solver == "caviar":
            kw = dict(mesh=mesh, iters=args.iters, seed=args.seed,
                      msrmp=args.msrmp, powers=args.powers,
                      analytic_mc=args.analytic_mc,
                      sweep_block_size=args.sweep_block_size,
                      trace_wire=args.trace_wire, verbose=verbose)
            priors = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
                      p["phi_cov"])
            if args.checkpoint:
                out = dist.caviar_resumable_distributed(
                    psc, stim, *priors, checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every, **kw)
            else:
                out = dist.caviar_sharded_distributed(psc, stim, *priors,
                                                      **kw)
            mu, beta, lam, shape, rate, phi, phi_cov, z, _ = out
            payload = dict(mu=mu, beta=beta, lam=lam, shape=shape, rate=rate,
                           phi=phi, phi_cov=phi_cov, z=z)
        elif args.solver == "sns":
            out = dist.cavi_sns_sharded_distributed(
                psc, stim, p["mu"], p["beta"], p["alpha"], p["shape"],
                p["rate"], p["phi"], p["phi_cov"], mesh=mesh,
                iters=args.iters, seed=args.seed, powers=args.powers,
                analytic_mc=args.analytic_mc, trace_wire=args.trace_wire,
                verbose=verbose)
            mu, beta, alpha, lam, shape, rate, phi, phi_cov = out
            payload = dict(mu=mu, beta=beta, alpha=alpha, lam=lam,
                           shape=shape, rate=rate, phi=phi, phi_cov=phi_cov)
        else:
            out = dist.mbcs_sharded_distributed(
                psc, stim, p["mu"], p["beta"], p["shape"], p["rate"],
                mesh=mesh, iters=args.iters, seed=args.seed,
                powers=args.powers, analytic_noise=True,
                trace_wire=args.trace_wire, verbose=verbose)
            mu, beta, lam, shape, rate, z, rf = out
            payload = dict(mu=mu, beta=beta, lam=lam, shape=shape, rate=rate,
                           z=z)
        if args.out:
            np.savez(args.out, **payload)
        print(json.dumps({
            "process": mesh.rank,
            "processes": mesh.world,
            "devices": mesh.size,
            "K_local": int(psc.shape[0]),
            "K_global": int(lam.shape[1]),
            "nonzero_weights": int((np.asarray(mu) != 0).sum()),
        }), flush=True)
    finally:
        torch.distributed.destroy_process_group()
