#!/bin/bash
# Unmasked finetune from a released 512 checkpoint on the PyTorch port (the
# twin of scripts/finetune_latent512.sh, the same config and flags):
# --ckpt_path takes the reference .pt, imported non-strictly (the mask
# token the file lacks keeps its initialisation). PYTHON (default python3)
# is the interpreter.
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
"$PYTHON" -m maskdit_tpu_torch.train --config configs/finetune/imagenet512-latent.yaml \
    --ckpt_path checkpoints/1050000.pt --use_strict_load False
