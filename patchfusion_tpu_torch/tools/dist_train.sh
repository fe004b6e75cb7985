#!/usr/bin/env bash
# Multi-process training launch of the port (the JAX package's
# tools/dist_train.sh, with its arguments): one process per rank, each on
# its own card (its id modulo the host's cards, or LOCAL_RANK), over nccl
# (gloo with --device cpu). Run it once per rank:
#   bash patchfusion_tpu_torch/tools/dist_train.sh CONFIG NUM_PROCS PROCESS_ID COORDINATOR [extra]
# COORDINATOR is HOST:PORT of rank 0; extra flags go to
# patchfusion_tpu_torch.tools.train. $PYTHON names the interpreter
# (default python).
set -e
CONFIG=$1; NPROC=$2; PID=$3; COORD=$4; shift 4
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" exec "${PYTHON:-python}" \
  -m patchfusion_tpu_torch.tools.train "$CONFIG" \
  --num-processes "$NPROC" --process-id "$PID" --coordinator "$COORD" "$@"
