#!/bin/bash
# ImageNet-256 pretrain at mask 0.5 on the PyTorch port (the twin of
# scripts/train_latent256.sh, the same config). On one card as it stands;
# for several processes run the same module under
# `python -m torch.distributed.run --nproc_per_node N`, which gives each
# process its rank (add `--mesh data=,fsdp=,tensor=` for the sharded mesh).
# PYTHON (default python3) is the interpreter.
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
"$PYTHON" -m maskdit_tpu_torch.train --config configs/train/imagenet256-latent.yaml
