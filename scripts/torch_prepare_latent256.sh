#!/bin/bash
# Encode ImageNet 256x256 into latents with the PyTorch port's SD-VAE (the
# twin of scripts/prepare_latent256.sh, the same arguments; on the card).
# PYTHON (default python3) is the interpreter.
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
"$PYTHON" -m maskdit_tpu_torch.extract_latent --resolution 256 \
    --ckpt assets/stable_diffusion/autoencoder_kl.pth \
    --batch_size 64 --outdir ../data/imagenet256-latent
