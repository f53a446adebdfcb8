#!/bin/bash
# NeuroCAAS cloud entry point for circuitmap_torch (port of
# scripts_tpu/run_circuitmap_main.sh).
#
# Pull the experiment data + YAML config from the job's cloud storage,
# run the end-to-end demix + CAVIaR pipeline on the GPU
# (`python -m circuitmap_torch fit`), zip the results, push them back.
#
#   * one runtime: the pipeline is one PyTorch process, with no
#     conda-environment switching;
#   * with neurocaas-contrib installed it speaks the NeuroCAAS workflow
#     protocol; otherwise DATA_PATH / CONFIG_PATH / RESULT_PATH
#     environment variables (or arguments 1-3) select local or
#     pre-fetched files, so the same script drives local runs, CI and
#     cloud jobs. Arguments after the first three go on to `fit`, e.g.
#     `--device cpu` or `--iters 20`.
#
#   circuitmap_torch/scripts/run_circuitmap_main.sh DATA CONFIG OUT_DIR [fit flags]

set -euo pipefail

REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"

if command -v neurocaas-contrib >/dev/null 2>&1; then
    echo "---- DOWNLOADING DATA (neurocaas) ----"
    neurocaas-contrib workflow get-data
    neurocaas-contrib workflow get-config
    datapath="$(neurocaas-contrib workflow get-datapath)"
    configpath="$(neurocaas-contrib workflow get-configpath)"
    resultpath="$(neurocaas-contrib workflow get-resultpath-tmp)"
    dataname="$(neurocaas-contrib workflow get-dataname)"
else
    datapath="${DATA_PATH:-${1:?usage: run_circuitmap_main.sh DATA CONFIG OUT_DIR [fit flags] (or install neurocaas-contrib)}}"
    configpath="${CONFIG_PATH:-${2:?missing CONFIG path}}"
    resultpath="${RESULT_PATH:-${3:?missing OUT_DIR}}"
    dataname="$(basename "$datapath")"
fi
shift $(( $# < 3 ? $# : 3 ))
savname="${dataname%.*}_cm"
mkdir -p "$resultpath"

echo "---- LAUNCHING CIRCUITMAP (torch) ----"
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
    python3 -m circuitmap_torch fit \
    --data "$datapath" --config "$configpath" --out "$resultpath" "$@"

echo "---- PACKAGING RESULTS ----"
( cd "$resultpath" && zip -qr "$savname.zip" . -x "$savname.zip" )

if command -v neurocaas-contrib >/dev/null 2>&1; then
    echo "---- UPLOADING RESULTS ----"
    neurocaas-contrib workflow put-result -r "$resultpath/$savname.zip"
else
    echo "results: $resultpath/$savname.zip"
fi
