#!/bin/bash
# The DER matrix of evals/run_matrix.sh through the port: the same 8 runs of
# `python -m sdtk_tpu_torch.evals.der` (speaker count, held-out tiers,
# overlap, music), one JSON line each.  BACKEND defaults to gpu (the card);
# extra arguments go to every run, e.g. `--device cpu --backend fake`.
# Usage: bash sdtk_tpu_torch/evals/run_matrix.sh [extra evals.der args...]
set -u
cd "$(dirname "$0")/../.."
B=${BACKEND:-gpu}
PY=${PYTHON:-python}
run() { echo "### $*" >&2; "$PY" -m sdtk_tpu_torch.evals.der --backend "$B" "$@"; }
run "$@"
run --speakers 4 "$@"
run --heldout --tier clean "$@"
run --heldout --tier noise "$@"
run --heldout --tier reverb "$@"
run --heldout --tier telephone "$@"
run --heldout --tier clean --overlap-frac 0.3 "$@"
run --heldout --tier music --snr-db 10 --gap-frac 0.5 "$@"
