#!/usr/bin/env bash
# Evaluation launch of the port (the JAX package's tools/dist_test.sh, with
# its arguments):
#   bash patchfusion_tpu_torch/tools/dist_test.sh CONFIG [extra]
# extra flags go to patchfusion_tpu_torch.tools.test. Several ranks join
# through torchrun's variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
# LOCAL_RANK) set around each call. $PYTHON names the interpreter (default
# python).
set -e
CONFIG=$1; shift 1
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" exec "${PYTHON:-python}" \
  -m patchfusion_tpu_torch.tools.test "$CONFIG" "$@"
