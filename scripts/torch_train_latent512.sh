#!/bin/bash
# ImageNet-512 pretrain on the PyTorch port (the twin of
# scripts/train_latent512.sh, the same config; the reference launched 32
# processes on 4 machines). Run the same module on every process under
# `python -m torch.distributed.run` (its --nnodes / --nproc_per_node /
# --rdzv_endpoint), or pass --coordinator / --num_processes / --process_id
# per process by hand. PYTHON (default python3) is the interpreter.
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
"$PYTHON" -m maskdit_tpu_torch.train --config configs/train/imagenet512-latent.yaml
