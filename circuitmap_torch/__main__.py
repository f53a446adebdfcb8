"""Command line: ``python -m circuitmap_torch <command> [args...]``.

The JAX package's workflow commands (``python -m circuitmap_tpu``), in
its groups, each in process:

* ``fit`` and ``serve`` are this module's: ``serve`` runs the persistent
  fit server (``serve.run_server``), which speaks the JAX package's
  wire, so either package's ``FitClient`` talks to it; ``fit`` runs
  demix + CAVIaR on an experiment file and exports the weights, in this
  process or, with ``--server URL``, on a resident fit server;
* every other command is ``circuitmap_torch.scripts.<module>.main``,
  the port of ``scripts_tpu/<module>.py`` (same flags, output files and
  printed lines; the measurement commands write ``*_H100.json`` where
  the JAX scripts write their TPU records);
* ``reference-baseline`` and ``parity-vr`` are listed, not ported: both
  run the original implementation, which is not in the repository;
  calling one exits 2.

Each command runs on the GPU unless given ``--device cpu``.
``python -m circuitmap_torch`` (or ``help``) lists the commands;
``<command> --help`` gives each one's flags; ``version`` prints the
package version.
"""

from __future__ import annotations

import argparse
import importlib
import sys

# the JAX commands that time or compare against the original
# implementation, which is not in the repository (listed, not ported)
_NOT_PORTED = "not ported"

# (command, module of circuitmap_torch.scripts, None for this module's
# own, or _NOT_PORTED; one-line help), in the JAX package's groups
_GROUPS = [
    ("Mapping workflows", [
        ("fit", None,
         "demix + CAVIaR on an experiment file (.mat/.npy/.npz), "
         "export weights"),
        ("pipeline-1v10", "run_1v10_pipeline",
         "1-vs-10 ground-truth pipeline (patched-cell validation)"),
        ("pipeline-pair-patch", "run_pair_patch_pipeline",
         "paired-patch ground-truth pipeline"),
        ("continuous", "run_continuous_experiment",
         "continuous-stimulation benchmark harness (YAML config)"),
        ("loho-cv", "run_loho_cv",
         "leave-one-hologram-out cross-validation (one fold per call)"),
        ("fanout-jobs", "generate_fanout_jobs",
         "emit SLURM/bash fan-out scripts for LOHO-CV folds"),
        ("distributed-fit", "run_distributed_fit",
         "multi-process (multi-host) sharded CAVIaR worker"),
    ]),
    ("Demixer", [
        ("train-demixer", "train_demixer",
         "train a neural waveform demixer (per-opsin presets)"),
        ("train-qat-demixer", "train_qat_demixer",
         "quantisation-aware training for the int4/int4d2 trace wires"),
        ("denoise-grids", "denoise_grids",
         "batch-denoise grid experiment files with a demixer"),
        ("export-ckpt", "export_lightning",
         "export a trained demixer as a reference-compatible "
         "Lightning .ckpt"),
    ]),
    ("Simulation studies", [
        ("simulations", "run_simulations",
         "simulation benchmark sweep (recovery vs trials/noise)"),
        ("downsampling", "run_downsampling",
         "trial-count downsampling experiment"),
        ("signal-fidelity", "run_signal_fidelity",
         "demixing fidelity vs stimulation frequency"),
        ("design-study", "design_study",
         "adaptive closed-loop vs static design policy "
         "(DESIGN_STUDY.json)"),
    ]),
    ("Operations", [
        ("serve", None,
         "persistent fit server: one resident process owns the GPU, "
         "fits arrive over HTTP"),
        ("doctor", "doctor",
         "diagnose the runtime environment (GPU, CUDA kernel library, "
         "zoo, build directory) with hang-proof probes"),
        ("hw-smoke", "hw_smoke",
         "exercise the full GPU compute path on the card (run after a "
         "driver or rig change)"),
        ("warm-cache", "warm_cache",
         "build the CUDA kernels and run the pipeline once for "
         "deployment shapes"),
    ]),
    ("Measurement / profiling", [
        ("scaling-study", "run_scaling_study",
         "on-card shape-scaling study (SCALING_H100.json)"),
        ("memory-cliff", "probe_memory_cliff",
         "walk the single-card OOM ladder (MEMORY_CLIFF_H100.json)"),
        ("wire-study", "wire_fidelity_study",
         "trace-wire fidelity study (WIRE_STUDY_H100.json)"),
        ("compile-study", "measure_many_compile",
         "caviar_many cold/warm setup cost (COMPILE_STUDY_H100.json)"),
        ("reference-baseline", _NOT_PORTED,
         "not ported (needs the original implementation)"),
        ("parity-vr", _NOT_PORTED,
         "not ported (needs the original implementation)"),
        ("profile-fit", "profile_fit_entry",
         "stage attribution of the public fit entry"),
        ("profile-demixer", "profile_demixer",
         "demixer forward wall/device profile"),
        ("profile-online", "profile_online",
         "closed-loop update latency profile"),
    ]),
]

_COMMANDS = {name: module for _, rows in _GROUPS for name, module, _ in rows}


def usage() -> str:
    lines = ["usage: python -m circuitmap_torch <command> [args...]",
             "       python -m circuitmap_torch <command> --help", ""]
    for title, rows in _GROUPS:
        lines.append(title + ":")
        for name, _module, blurb in rows:
            lines.append(f"  {name:<22}{blurb}")
        lines.append("")
    lines.append("version: print the package version")
    return "\n".join(lines)


def serve_main(argv=None):
    from .utils.synthetic import parse_shape

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch serve",
        description="persistent fit server: one process owns the GPU, "
                    "fits arrive over HTTP")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default localhost-only; "
                             "the protocol is unauthenticated — front "
                             "it with an SSH tunnel or reverse proxy "
                             "to expose it beyond the host)")
    parser.add_argument("--port", type=int, default=None,
                        help="port (default 8799; 0 = OS-assigned, "
                             "printed as 'SERVING ... port=<p>')")
    parser.add_argument("--device", default=None,
                        help="torch device to serve from (default cuda; "
                             "'cpu' runs without a GPU)")
    parser.add_argument("--demixer", default=None,
                        help="demixer checkpoint (.npz/.ckpt) the "
                             "server loads once and applies to every "
                             "request that asks (or 'default' for a "
                             "fresh default-architecture net); omit "
                             "to serve raw-trace fits only")
    parser.add_argument("--wire", default=None,
                        choices=["f32", "f16", "int8", "int4", "int4d2"],
                        help="default trace wire for demix uploads "
                             "(per-request X-Options override)")
    parser.add_argument("--max-mb", type=float, default=2048,
                        help="largest accepted request body, MB")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="shard fits over a mesh of N shards: the "
                             "first N GPUs, or N shards on --device when "
                             "one is named")
    parser.add_argument("--warm", type=parse_shape, nargs="*", default=[],
                        metavar="NxK",
                        help="run the pipeline once at these shapes "
                             "before accepting requests (kernel build, "
                             "library handles, allocator pools)")
    parser.add_argument("--state-dir", default=None,
                        help="directory for stream checkpoints: enables "
                             "POST /stream/<name>/{save,load} and "
                             "auto-saves live streams on graceful "
                             "shutdown, so a restart does not lose a "
                             "closed-loop experiment")
    parser.add_argument("--token", default=None,
                        help="require `Authorization: Bearer <token>` on "
                             "every request (FitClient(token=...))")
    parser.add_argument("--metrics", default=None, metavar="FILE",
                        help="append one JSON line per request (ts, "
                             "method, path, status, seconds, bytes)")
    parser.add_argument("--status-port", type=int, default=None,
                        metavar="P",
                        help="read-only liveness sidecar on its own "
                             "thread and port (GET /health; 0 = OS-"
                             "assigned, printed as 'STATUS ... "
                             "port=<p>'): answers while the main port "
                             "is busy and reports the in-flight request")
    parser.add_argument("--request-timeout-s", type=float, default=None,
                        metavar="S",
                        help="watchdog: if one request runs past S "
                             "seconds, log a JSON diagnostic, save "
                             "streams (--state-dir, bounded) and exit "
                             "with code 86 so a supervisor restarts the "
                             "server")
    parser.add_argument("--verbose", action="store_true",
                        help="log every request")
    args = parser.parse_args(argv)

    from .serve import DEFAULT_PORT, run_server

    try:
        run_server(host=args.host,
                   port=DEFAULT_PORT if args.port is None else args.port,
                   demixer_path=args.demixer, default_wire=args.wire,
                   max_mb=args.max_mb, warm_shapes=args.warm,
                   verbose=args.verbose, mesh_devices=args.mesh,
                   state_dir=args.state_dir, metrics_path=args.metrics,
                   auth_token=args.token, status_port=args.status_port,
                   request_timeout_s=args.request_timeout_s,
                   device=args.device)
    except KeyboardInterrupt:
        print("fit server stopped", file=sys.stderr)
    return 0


def fit_main(argv=None):
    """Load psc + stimulus_matrix, demix with the config's checkpoint,
    fit CAVIaR at the config's msrmp and export .mat + .npz. With
    ``--server URL`` the fit runs on a resident fit server instead: the
    traces ship f16 over HTTP (f32 when the config's ``transfer_dtype``
    is f32), the server's own demixer applies, and the same files are
    written here."""
    from pathlib import Path

    import numpy as np

    from .utils.io import export_state, load_experiment

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch fit", description=fit_main.__doc__)
    parser.add_argument("--data", required=True)
    parser.add_argument("--config", required=True,
                        help="YAML with keys demixer (checkpoint path), "
                             "msrmp (float), optionally powers and "
                             "transfer_dtype")
    parser.add_argument("--out", required=True)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--device", default=None,
                        help="torch device of an in-process fit (default "
                             "cuda; 'cpu' runs without a GPU)")
    parser.add_argument("--server", default=None, metavar="URL",
                        help="run the fit on a resident fit server "
                             "(e.g. http://gpu-host:8799) instead of "
                             "this process; the server's --demixer "
                             "applies")
    args = parser.parse_args(argv)

    import yaml

    with open(args.config) as fh:
        config = yaml.safe_load(fh)
    psc, stim_matrix = load_experiment(args.data)
    N = stim_matrix.shape[0]
    fit_options = {"msrmp": float(config["msrmp"]), "iters": args.iters,
                   "save_histories": False}
    if "powers" in config:  # the rig's power levels
        fit_options["powers"] = [float(p) for p in config["powers"]]
    wire_tok = config.get("transfer_dtype", "f16")

    if args.server:
        from .serve import FitClient

        # typed arrays halve the HTTP body; an EXPLICIT f32 transfer
        # is a full-precision request and keeps f32 on the HTTP leg too
        http_dtype = np.float32 if str(wire_tok).lower() in (
            "f32", "float32") else np.float16
        state = FitClient(args.server).fit(
            psc.astype(http_dtype), stim_matrix.astype(np.float32),
            demix=True, trace_wire=wire_tok, verbose=False, **fit_options)
        print(f"CAVIaR fit complete on {args.server} "
              f"in {float(state['fit_time_s']):.2f}s (server-side).")
    else:
        from .demix.demixer import NeuralDemixer
        from .model import Model

        demix = NeuralDemixer(path=config["demixer"], device=args.device)
        psc_dem = demix(psc, keep_on_device=True, transfer_dtype=wire_tok)
        model = Model(N).fit(psc_dem, stim_matrix, method="caviar",
                             fit_options=fit_options, device=args.device)
        print(f"CAVIaR fit complete in {model.time:.2f}s.")
        state = model.state

    written = export_state(args.out, Path(args.data).stem, state)
    print("Wrote:", ", ".join(written))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        from . import __version__

        print(__version__)
        return 0
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n\n{usage()}", file=sys.stderr)
        return 2
    module = _COMMANDS[cmd]
    if module is _NOT_PORTED:
        print(f"{cmd}: not ported (needs the original implementation, "
              "which is not in the repository)", file=sys.stderr)
        return 2
    if module is None:
        run = {"fit": fit_main, "serve": serve_main}[cmd]
    else:
        run = importlib.import_module(f"{__package__}.scripts.{module}").main
    rc = run(rest)
    return 0 if rc is None else rc


if __name__ == "__main__":
    sys.exit(main())
