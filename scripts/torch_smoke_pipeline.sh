#!/bin/bash
# Full-pipeline smoke on the PyTorch port (the twin of
# scripts/smoke_pipeline.sh): fixture images -> extract_latent -> lmdb2wds
# -> train (lmdb) -> generate (+ VAE decode) -> fid ref/calc, every CLI of
# python -m maskdit_tpu_torch.* end to end with a random-weight SD-VAE made
# by the port (models/vae.py, the released autoencoder_kl.pth layout).
#
# Runs from its own checkout, in a root directory: PIPE_ROOT (a new or empty
# directory, kept afterwards) or by default a new mktemp -d directory,
# removed at the end. DEVICE (default cuda) is the
# torch device of every stage; PYTHON (default python3) the interpreter.
# The train stage reads configs/train/synthetic-smoke.yaml where PyYAML is
# installed, else the same values as JSON (SMOKE_CONFIG_JSON below;
# tests/test_torch_scripts.py holds the two equal).
set -eo pipefail
cd "$(dirname "$0")/.."
PYTHON="${PYTHON:-python3}"
DEVICE="${DEVICE:-cuda}"
if [[ -n "${PIPE_ROOT:-}" ]]; then
  ROOT="$PIPE_ROOT"
else
  ROOT="$(mktemp -d)"
  trap 'rm -rf "$ROOT"' EXIT
fi
mkdir -p "$ROOT/raw/train"

"$PYTHON" - "$ROOT" <<'EOF'
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from maskdit_tpu_torch.models.vae import AutoencoderKL
from maskdit_tpu_torch.utils.png import write_png

root = sys.argv[1]
rng = np.random.RandomState(0)
for cls in ("c0", "c1"):
    os.makedirs(f"{root}/raw/train/{cls}", exist_ok=True)
    for i in range(8):
        arr = rng.randint(0, 255, size=(72, 72, 3), dtype=np.uint8)
        write_png(f"{root}/raw/train/{cls}/{i}.png", arr)
# a format-correct random VAE checkpoint: weights N(0, 0.02^2), GroupNorm
# scales 1 + that, seed 1
torch.manual_seed(1)
vae = AutoencoderKL()
with torch.no_grad():
    for p in vae.parameters():
        p.normal_(0.0, 0.02)
    for m in vae.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.weight.add_(1.0)
torch.save(vae.state_dict(), f"{root}/autoencoder_kl.pth")
print("fixture + random VAE ready", flush=True)
EOF

CONFIG=configs/train/synthetic-smoke.yaml
if ! "$PYTHON" -c "import yaml" 2>/dev/null; then
  CONFIG="$ROOT/synthetic-smoke.json"
  # SMOKE_CONFIG_JSON: configs/train/synthetic-smoke.yaml's values
  cat > "$CONFIG" <<'JSON'
{"data": {"dataset": "synthetic", "category": "synthetic", "resolution": 16, "num_channels": 4,
          "length": 256},
 "model": {"precond": "edm", "model_type": "DiT-S/2", "in_size": 16, "in_channels": 4,
           "num_classes": 16, "use_decoder": true, "ext_feature_dim": 0, "pad_cls_token": false,
           "mask_ratio": 0.5, "mask_ratio_fn": "constant", "mask_ratio_min": 0,
           "mae_loss_coef": 0.1, "class_dropout_prob": 0.1},
 "train": {"fp32": false, "batchsize": 8, "grad_accum": 1, "epochs": 2, "lr": 0.0001,
           "lr_rampup_kimg": 1, "xflip": false, "max_num_steps": 20},
 "eval": {"batchsize": 8, "ref_path": "None"},
 "log": {"log_every": 5, "ckpt_every": 10, "tag": "smoke"},
 "wandb": {"entity": "none", "project": "none", "group": "none"}}
JSON
  echo "(no PyYAML: configs/train/synthetic-smoke.yaml's values as $CONFIG)"
fi

echo "=== extract_latent ==="
"$PYTHON" -m maskdit_tpu_torch.extract_latent --data_name pipe --data_dir "$ROOT/raw" \
  --split train --resolution 64 --batch_size 8 --ckpt "$ROOT/autoencoder_kl.pth" \
  --outdir "$ROOT/latents" --device "$DEVICE" 2>&1 | grep -v WARNING | tail -2

echo "=== lmdb2wds ==="
"$PYTHON" -m maskdit_tpu_torch.lmdb2wds --datadir "$ROOT/latents/pipe_64_latent_lmdb" \
  --outdir "$ROOT/wds" --resolution 8 --num_channels 8 --maxcount 10 \
  2>&1 | grep -v WARNING | tail -1

echo "=== train (lmdb latents) ==="
"$PYTHON" -m maskdit_tpu_torch.train --config "$CONFIG" \
  --results_dir "$ROOT/results" --num_workers 1 --max_steps 4 --device "$DEVICE" \
  data.category=lmdb data.root="$ROOT/latents/pipe_64_latent_lmdb" \
  data.dataset=pipe data.resolution=8 model.in_size=8 model.num_classes=2 \
  log.ckpt_every=4 log.log_every=2 2>&1 | grep -v WARNING | tail -3

echo "=== generate (with VAE decode to PNG) ==="
CKPT=$(ls "$ROOT"/results/*/checkpoints/ckpt_*4.pt | head -1)
"$PYTHON" -m maskdit_tpu_torch.generate --ckpt_path "$CKPT" --outdir "$ROOT/samples" \
  --seeds 0-7 --max_batch_size 4 --model_type DiT-S/2 --image_size 8 \
  --num_classes 2 --use_decoder True --mae_loss_coef 0.1 --num_steps 4 \
  --cfg_scale 1.5 --pretrained_path "$ROOT/autoencoder_kl.pth" --device "$DEVICE" \
  2>&1 | grep -v WARNING | tail -2
ls "$ROOT"/samples/*.png | head -3

echo "=== fid ref + calc ==="
"$PYTHON" -m maskdit_tpu_torch.fid ref --data "$ROOT/raw/train" --dest "$ROOT/ref.npz" \
  --batch 8 --random_detector --device "$DEVICE" 2>&1 | grep -v WARNING | tail -1
"$PYTHON" -m maskdit_tpu_torch.fid calc --images "$ROOT/samples" --ref "$ROOT/ref.npz" \
  --num 8 --batch 8 --random_detector --device "$DEVICE" 2>&1 | grep -v WARNING | tail -2
echo "=== PIPELINE COMPLETE ==="
