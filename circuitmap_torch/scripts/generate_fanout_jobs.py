"""Cluster-scale fan-out generator for LOHO-CV (port of
``scripts_tpu/generate_fanout_jobs.py``).

  * The worker it launches is ``<python> -m circuitmap_torch loho-cv
    --fold $TASK_ID``, one fit per held-out hologram.
  * The fold count is derived from the data (unique holograms in the
    stim matrix), so array bounds cannot drift out of sync with the
    experiment.
  * Three backends: ``slurm`` emits chunked job-array scripts (arrays
    capped at --max-array jobs each); ``bash`` emits a plain xargs -P
    fan-out for one multi-core host; ``list`` prints one command per
    fold for any external scheduler.
  * Nothing is submitted unless ``--submit`` is passed.

Each fold is an independent fit on its worker's own GPU (``--device``
is passed on to the workers when given).

Usage:
  python -m circuitmap_torch fanout-jobs --data expt.npz \
      --backend slurm --out-dir jobs/ [--submit]
"""

import argparse
import os
import shlex
import stat
import subprocess
import sys

SLURM_TEMPLATE = """\
#!/bin/bash
#SBATCH --job-name={name}
#SBATCH -c {cpus}
#SBATCH -o {log_dir}/slurm-%A_%a.out
#SBATCH --mem-per-cpu={mem}
#SBATCH --array=0-{last}
{extra_directives}
FOLD=$(( SLURM_ARRAY_TASK_ID + {start} ))
{python} {worker} --data {data} {worker_args} --fold $FOLD --out {out}
"""

BASH_TEMPLATE = """\
#!/bin/bash
# {n} folds fanned out over {jobs} local workers
set -e
seq 0 {last} | xargs -I{{}} -P {jobs} -n 1 \\
  {python} {worker} --data {data} {worker_args} --fold {{}} --out {out}
"""

WORKER = "-m circuitmap_torch loho-cv"


def count_folds(data_path):
    from ..parallel.sweep import loho_folds
    from ..utils.io import load_experiment

    _psc, stim = load_experiment(data_path)
    return sum(1 for _ in loho_folds(stim))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch fanout-jobs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", required=True)
    ap.add_argument("--backend", default="slurm",
                    choices=["slurm", "bash", "list"])
    ap.add_argument("--method", default="caviar",
                    choices=["caviar", "cavi_sns", "mbcs"])
    ap.add_argument("--demixer", default=None)
    ap.add_argument("--msrmp", type=float, default=0.3)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default="loho_cv.json")
    ap.add_argument("--out-dir", default="fanout_jobs")
    ap.add_argument("--max-array", type=int, default=1000,
                    help="max jobs per SLURM array")
    ap.add_argument("--jobs", type=int, default=4,
                    help="bash backend: concurrent local workers")
    ap.add_argument("--cpus", type=int, default=1)
    ap.add_argument("--mem", default="8gb")
    ap.add_argument("--extra-directives", default="",
                    help="newline-separated extra #SBATCH lines "
                         "(partition, gres, account, ...)")
    ap.add_argument("--submit", action="store_true",
                    help="sbatch the generated scripts (slurm backend)")
    ap.add_argument("--device", default=None,
                    help="torch device of each worker's fit, passed on "
                         "as the workers' --device (default: theirs, cuda)")
    args = ap.parse_args(argv)

    n = count_folds(args.data)
    if n == 0:
        raise SystemExit("no holograms found in the stim matrix")

    wargs = f"--method {args.method} --msrmp {args.msrmp} --iters {args.iters}"
    if args.demixer:
        wargs += f" --demixer {shlex.quote(args.demixer)}"
    if args.device:
        wargs += f" --device {shlex.quote(args.device)}"
    common = dict(python=shlex.quote(sys.executable), worker=WORKER,
                  data=shlex.quote(args.data), worker_args=wargs,
                  out=shlex.quote(args.out))

    if args.backend == "list":
        for fold in range(n):
            print(f"{common['python']} {common['worker']} --data "
                  f"{common['data']} {wargs} --fold {fold} --out "
                  f"{common['out']}")
        return

    os.makedirs(args.out_dir, exist_ok=True)
    log_dir = os.path.join(args.out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)

    scripts = []
    if args.backend == "bash":
        path = os.path.join(args.out_dir, "run_loho_cv_fanout.sh")
        with open(path, "w") as f:
            f.write(BASH_TEMPLATE.format(n=n, last=n - 1, jobs=args.jobs,
                                         **common))
        scripts.append(path)
    else:  # slurm, chunked arrays
        start = 0
        while start < n:
            size = min(args.max_array, n - start)
            path = os.path.join(
                args.out_dir, f"loho_cv_{args.method}_start{start}.sh")
            with open(path, "w") as f:
                f.write(SLURM_TEMPLATE.format(
                    name=f"loho_cv_{args.method}", cpus=args.cpus,
                    mem=args.mem, log_dir=log_dir, last=size - 1,
                    start=start,
                    extra_directives=args.extra_directives, **common))
            scripts.append(path)
            start += size

    for path in scripts:
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
        print("wrote", path)
    print(f"{n} folds across {len(scripts)} script(s)")

    if args.submit:
        if args.backend != "slurm":
            raise SystemExit("--submit only applies to the slurm backend")
        for path in scripts:
            subprocess.run(["sbatch", path], check=True)
