#!/bin/bash
# Strong-scaling sweep of the port over process counts, started from the
# shell: the port's counterpart of scripts/scaling_tests/
# launch_scaling_sweep.sh. Each sweep point starts N processes of
# `python -m hydra_pspec_torch.scripts.scaling_test --worker`, each running
# its block of the baselines through the CLI's run_jobs on its card (gloo
# over localhost between them), then the table of every point is printed
# with the files of each point held against those of one process.
#
# Usage:
#   hydra_pspec_torch/scripts/launch_scaling_sweep.sh OUT_DIR "1 2 4" \
#       [scaling_test options: --n 16 --niter 20 --data DATA_DIR ...]
#
#   OUT_DIR: one subdirectory per sweep point is created (ranks-1/ ...),
#            each with its run under res/ and its timings.json
#   second argument: the process counts to sweep (1 first: the reference)
#   DEVICE (environment, default cuda): cuda, or cpu to rehearse the sweep
#   PORT (environment, default 12411): the first point's gloo port
set -euo pipefail

OUT_DIR=${1:?output dir}
COUNTS=${2:-"1 2"}
shift 2 || shift $#
PORT=${PORT:-12411}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"

for n in $COUNTS; do
  point="$OUT_DIR/ranks-$n"
  mkdir -p "$point"
  echo "=== sweep point: $n process(es) ==="
  pids=()
  for ((p = 0; p < n; p++)); do
    python -m hydra_pspec_torch.scripts.scaling_test "$@" \
      --device "$DEVICE" --worker "$point" --rank "$p" --nranks "$n" \
      --port "$PORT" &
    pids+=($!)
  done
  for pid in "${pids[@]}"; do wait "$pid"; done
  PORT=$((PORT + 1))
done
python -m hydra_pspec_torch.scripts.scaling_test --table "$OUT_DIR"
