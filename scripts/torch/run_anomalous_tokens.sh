#!/bin/bash
# Sandbox launcher of the PyTorch port: anomalous-token input optimization over
# a ClipGPT/GPT-2 (the reference's anomalous_tokens/backwards.py CLI - test sets,
# random targets, plateau LR decay, success table through the experiment logger),
# on a CUDA card.
#
#   scripts/torch/run_anomalous_tokens.sh --model_name test-gpt --target 7 \
#       --epochs 50 --return_early --log outputs/anomalous.jsonl
set -euo pipefail
REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}:${PYTHONPATH:-}"
cd "${REPO_ROOT}"
python -u -c "
import sys
from summer_clip_torch.sandbox.anomalous_tokens import backwards_main
backwards_main(sys.argv[1:])
" "$@"
