#!/bin/bash
#SBATCH --job-name=gen_gpt
#SBATCH --gres=gpu:1
#SBATCH --time=1-0:0
# Launch of the PyTorch port (summer_clip_torch) on a CUDA card; meta.device=cpu
# runs it on the CPU. meta.world_size=N spreads an app that shards (save_features,
# image_attention, tip_adapter, train_prolip, train_gpt) over N ranks, one process a
# rank (summer_clip_torch.parallel.launch); gen_gpt takes generation.tp=N.
# Pass config overrides straight through: scripts/torch/gen_gpt.sh key=value ...

set -euo pipefail
REPO_ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="${REPO_ROOT}:${PYTHONPATH:-}"
export TRANSFORMERS_OFFLINE=1 HF_DATASETS_OFFLINE=1

cd "${REPO_ROOT}"
python -u -m summer_clip_torch.apps.gen_gpt "$@"
