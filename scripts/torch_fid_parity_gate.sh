#!/usr/bin/env bash
# One-command FID-parity gate on the PyTorch port (the twin of
# scripts/fid_parity_gate.sh, same flags, stages and TARGET_FID table).
#
# Chains the acceptance pipeline against the released reference
# checkpoints (reference README.md:48-53: FID 2.28 @256 cfg1.5, 5.69
# @256 uncond, 2.50 @512 cfg1.5, 10.79 @512 uncond):
#
#   1. asset presence check: exits 3 naming the first missing file (it
#      downloads nothing; put the files under assets/ by hand)
#   2. tools/torch_validate_port.py: conversion coverage + denoiser sanity
#   3. python -m maskdit_tpu_torch.eval_latent: 50K samples with
#      rank-strided seeds -> FID vs the reference statistics
#
# Usage:
#   scripts/torch_fid_parity_gate.sh [--res 256|512] [--cfg CFG] [--seeds 0-49999]
#   scripts/torch_fid_parity_gate.sh --dry-wire
#       wiring mode, no assets needed: makes format-correct stand-ins with
#       the port alone (16 random 64-px PNGs, a random SD-VAE in the
#       released autoencoder_kl.pth layout, a random DiT-S/2 at 16-px
#       latents, 16 classes, with a decoder, as {model, ema, args} in the
#       reference's key names), then runs the SAME three stages with
#       --random_detector on 16 seeds at 4 steps.
#
# DEVICE (default cuda) is the torch device of every stage; PYTHON (default
# python3) the interpreter; FID_GATE_TMP keeps the dry-wire fixtures there.
# Exits non-zero if any stage fails or (with assets) FID exceeds TARGET_FID.
set -euo pipefail
cd "$(dirname "$0")/.."

PYTHON="${PYTHON:-python3}"
DEVICE="${DEVICE:-cuda}"
RES=256
CFG=1.5
SEEDS="0-49999"
DRY=0
while [[ $# -gt 0 ]]; do
  case "$1" in
    --res) RES="$2"; shift 2 ;;
    --cfg) CFG="$2"; shift 2 ;;
    --seeds) SEEDS="$2"; shift 2 ;;
    --dry-wire) DRY=1; shift ;;
    *) echo "unknown arg $1" >&2; exit 2 ;;
  esac
done

# Default acceptance bar per (res, guidance): the published FID
# (reference README.md:48-53) + ~10% headroom for RNG-stream drift.
# 256 cfg: 2.28 -> 2.50 | 256 uncond: 5.69 -> 6.26
# 512 cfg: 2.50 -> 2.75 | 512 uncond: 10.79 -> 11.87
if [[ -z "${TARGET_FID:-}" ]]; then
  if   [[ "$RES" == 256 && "$CFG" != 1.0 ]]; then TARGET_FID=2.50
  elif [[ "$RES" == 256 ]];                  then TARGET_FID=6.26
  elif [[ "$CFG" != 1.0 ]];                  then TARGET_FID=2.75
  else                                            TARGET_FID=11.87
  fi
fi

if [[ "$DRY" == 1 ]]; then
  echo "== torch_fid_parity_gate: DRY WIRING MODE (no reference assets) =="
  TMP="${FID_GATE_TMP:-$(mktemp -d)}"
  [[ -z "${FID_GATE_TMP:-}" ]] && trap 'rm -rf "$TMP"' EXIT
  "$PYTHON" - "$TMP" <<'PY'
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.models.vae import AutoencoderKL
from maskdit_tpu_torch.utils.png import write_png

tmp = sys.argv[1]
# 1. fixture images for the FID reference statistics
os.makedirs(f"{tmp}/raw", exist_ok=True)
rng = np.random.RandomState(0)
for i in range(16):
    write_png(f"{tmp}/raw/{i}.png", rng.randint(0, 255, size=(64, 64, 3), dtype=np.uint8))
# 2. a random SD-VAE in the released autoencoder_kl.pth layout (weights
# N(0, 0.02^2), GroupNorm scales 1 + that, seed 1)
torch.manual_seed(1)
vae = AutoencoderKL()
with torch.no_grad():
    for p in vae.parameters():
        p.normal_(0.0, 0.02)
    for m in vae.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.weight.add_(1.0)
torch.save(vae.state_dict(), f"{tmp}/vae.pth")
# 3. a random DiT-S/2 in the reference .pt layout (its key names)
torch.manual_seed(0)
model = create_model("edm", img_resolution=16, img_channels=4, num_classes=16,
                     model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1)
sd = model.state_dict()
torch.save({"model": sd, "ema": sd, "args": {}}, f"{tmp}/ckpt.pt")
print("fabricated fixtures in", tmp, flush=True)
PY
  # the eval CLI's config, as JSON (the card's machine need not have PyYAML)
  cat > "$TMP/config.json" <<JSON
{"data": {"dataset": "dry", "category": "synthetic", "resolution": 16, "num_channels": 4},
 "model": {"precond": "edm", "model_type": "DiT-S/2", "in_size": 16, "in_channels": 4,
           "num_classes": 16, "use_decoder": true, "mask_ratio": 0.5, "mae_loss_coef": 0.1},
 "train": {"fp32": true, "batchsize": 8, "lr": 0.0001, "epochs": 1, "max_num_steps": 1},
 "eval": {"batchsize": 8, "ref_path": "$TMP/ref.npz"},
 "log": {"log_every": 1, "ckpt_every": 1}}
JSON
  echo "-- stage 1 (assets): fabricated --"
  "$PYTHON" -m maskdit_tpu_torch.fid ref --data "$TMP/raw" --dest "$TMP/ref.npz" --batch 8 \
      --random_detector --device "$DEVICE" 2>&1 | tail -1
  echo "-- stage 2 (port validation) --"
  "$PYTHON" tools/torch_validate_port.py --ckpt_path "$TMP/ckpt.pt" \
      --model_type DiT-S/2 --image_size 16 --num_classes 16 \
      --use_decoder True --mae_loss_coef 0.1 --outdir "$TMP/port_check" \
      --device "$DEVICE" 2>&1 | tail -3
  echo "-- stage 3 (sample -> FID) --"
  "$PYTHON" -m maskdit_tpu_torch.eval_latent --config "$TMP/config.json" \
      --ckpt_path "$TMP/ckpt.pt" --outdir "$TMP/out" \
      --seeds 0-15 --num_steps 4 --max_batch_size 8 --num_expected 16 \
      --fid_batch_size 8 --cfg_scale "$CFG" --random_detector \
      --pretrained_path "$TMP/vae.pth" --device "$DEVICE" 2>&1 | tail -2 | tee "$TMP/eval.log"
  grep -q "FID:" "$TMP/eval.log" || { echo "no FID line produced"; exit 5; }
  echo "== DRY WIRING OK: every stage of the gate is runnable =="
  exit 0
fi

echo "== torch_fid_parity_gate: res=$RES cfg=$CFG seeds=$SEEDS device=$DEVICE =="
ASSETS=assets
STATS_NAME=fid_stats_imagenet256_guided_diffusion.npz
[[ "$RES" == 512 ]] && STATS_NAME=VIRTUAL_imagenet512.npz
CKPT_NAME=imagenet${RES}-guidance.pt
OUT=eval_out/torch_fid_parity_${RES}

# stage 1: assets (nothing is downloaded)
for f in "$ASSETS/fid_stats/$STATS_NAME" "$ASSETS/ckpts/$CKPT_NAME"; do
  [[ -f "$f" ]] || { echo "missing asset: $f (not in the repository; place it by hand)"; exit 3; }
done
mkdir -p eval_out

# stage 2: port validation (fast gate: conversion coverage + denoiser sanity)
"$PYTHON" tools/torch_validate_port.py --ckpt_path "$ASSETS/ckpts/$CKPT_NAME" \
    --image_size $((RES / 8)) --use_decoder True --mae_loss_coef 0.1 --device "$DEVICE"

# stage 3: 50K samples -> FID vs published stats
CONFIG=configs/test/maskdit-${RES}.yaml
"$PYTHON" -m maskdit_tpu_torch.eval_latent --config "$CONFIG" \
    --ckpt_path "$ASSETS/ckpts/$CKPT_NAME" --outdir "$OUT" \
    --seeds "$SEEDS" --cfg_scale "$CFG" --device "$DEVICE" | tee "$OUT.log"

FID=$(grep -oE 'FID: [0-9.]+' "$OUT.log" | grep -oE '[0-9.]+' | tail -1)
echo "== measured FID: $FID (target <= $TARGET_FID) =="
"$PYTHON" - "$FID" "$TARGET_FID" <<'PY'
import sys
sys.exit(0 if float(sys.argv[1]) <= float(sys.argv[2]) else 4)
PY
echo "== FID PARITY GATE PASSED =="
