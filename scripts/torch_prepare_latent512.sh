#!/bin/bash
# Encode ImageNet 512x512 into latents with the PyTorch port, then shard
# them to WebDataset (the twin of scripts/prepare_latent512.sh, the same
# arguments; the encode on the card). PYTHON (default python3) is the
# interpreter.
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
"$PYTHON" -m maskdit_tpu_torch.extract_latent --resolution 512 \
    --ckpt assets/stable_diffusion/autoencoder_kl.pth \
    --batch_size 64 --outdir ../data/imagenet512-latent
"$PYTHON" -m maskdit_tpu_torch.lmdb2wds --maxcount 10010 --datadir ../data/imagenet512-latent \
    --outdir ../data/imagenet512-latent-wds --resolution 64 --num_channels 8
