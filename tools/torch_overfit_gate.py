"""Trainability gate of the PyTorch port: overfit a tiny DiT end to end
through the port's Trainer, then sample it back.

The twin of tools/overfit_gate.py, with the same fixture, configuration,
schedule and bounds:

  1. K distinct latents (one per class, std 2.75, logvar -30 so the
     reparameterization is deterministic), each repeated 16 times, written
     through the port's latent-LMDB writer (``write_latent_lmdb``) and read
     by its native reader;
  2. DiT-S/2 rebound to depth 4, hidden 128, 4 heads, with a 2 x 128 x 4
     decoder (the port's models/dit.py registry; restored afterwards)
     trained in fp32 through ``maskdit_tpu_torch.train.trainer.Trainer``:
     masked EDM loss + MAE, Adam + EMA, mask ratio ``cosine2`` from 0.5 down
     to 0 over the run;
  3. each class sampled from the EMA weights (``generate_with_params``,
     deterministic Heun, no CFG) and matched to its nearest training latent.

It passes if every sample's nearest latent is its own class's, the last
log windows' loss is under 0.12 and the mean on-target MSE is under 0.15 of
the off-target one.

Run:  python tools/torch_overfit_gate.py [--steps 2000] [--out DIR] [--device cuda]
Exit code 0 = gate passed; the JSON verdict prints on stdout. On a card
the attention and the update run the port's fp32 kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_fixture(root: str, k: int, res: int, channels: int, seed: int = 0,
                  repeat: int = 16):
    """K distinct latents, one class each, as a moments LMDB under
    ``root/latent_lmdb/train`` (the JAX gate's ``build_fixture``): targets
    at std 2.75 so the trained-on tensor (x 0.18215) sits at EDM's
    sigma_data 0.5; logvar -30 makes the draw's noise term ~3e-7; each
    record repeats ``repeat`` times so an epoch holds full batches."""
    from maskdit_tpu_torch.data.datasets import write_latent_lmdb

    rng = np.random.RandomState(seed)
    targets = rng.randn(k, channels, res, res).astype(np.float32) * 2.75
    logvar = np.full_like(targets, -30.0)
    moments = np.tile(np.concatenate([targets, logvar], axis=1), (repeat, 1, 1, 1))
    labels = np.tile(np.arange(k), repeat)
    write_latent_lmdb(os.path.join(root, "latent_lmdb", "train"), moments, labels)
    return os.path.join(root, "latent_lmdb"), targets


def gate_config(root: str, res: int, channels: int, k: int, batch: int, lr: float,
                steps: int, ema_decay: float, mask_ratio: float, mask_fn: str) -> dict:
    """The JAX gate's CONFIG_TMPL, as a dict (the card's machine need not
    have PyYAML)."""
    return {
        "data": {"dataset": "overfit", "category": "lmdb", "root": root,
                 "resolution": res, "num_channels": channels},
        "model": {"precond": "edm", "model_type": "DiT-S/2", "in_size": res,
                  "in_channels": channels, "num_classes": k, "use_decoder": True,
                  "ext_feature_dim": 0, "pad_cls_token": False, "mask_ratio": mask_ratio,
                  "mask_ratio_fn": mask_fn, "mask_ratio_min": 0.0, "mae_loss_coef": 0.1,
                  "class_dropout_prob": 0.0},
        "train": {"fp32": True, "batchsize": batch, "grad_accum": 1, "epochs": 1, "lr": lr,
                  "lr_rampup_kimg": 0, "xflip": False, "max_num_steps": steps,
                  "ema_decay": ema_decay},
        "eval": {"batchsize": 8, "ref_path": "None"},
        "log": {"log_every": max(1, steps // 30), "ckpt_every": steps, "tag": "overfit"},
    }


def run_gate(
    steps: int = 2000,
    out: str | None = None,
    k: int = 8,
    res: int = 16,
    channels: int = 4,
    batch: int = 32,
    lr: float = 2e-3,
    ema_decay: float = 0.995,
    mask_ratio: float = 0.5,
    mask_fn: str = "cosine2",
    num_sample_steps: int = 18,
    tiny: bool = True,
    loss_floor: float = 0.12,
    mse_ratio_bound: float = 0.15,
    device: str = "cuda",
) -> dict:
    from maskdit_tpu_torch.models import dit

    saved = (dit.DIT_CONFIGS["DiT-S/2"], dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH,
             dit.DECODER_NUM_HEADS)
    if tiny:
        # the JAX gate's rebind: the gate tests the training system, not
        # capacity; depth 4 x hidden 128 memorizes 8 latents
        dit.DIT_CONFIGS["DiT-S/2"] = dict(depth=4, hidden_size=128, patch_size=2, num_heads=4)
        dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH, dit.DECODER_NUM_HEADS = 128, 2, 4
    try:
        return _run_gate_inner(steps, out, k, res, channels, batch, lr, ema_decay, mask_ratio,
                               mask_fn, num_sample_steps, loss_floor, mse_ratio_bound, device)
    finally:
        (dit.DIT_CONFIGS["DiT-S/2"], dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH,
         dit.DECODER_NUM_HEADS) = saved


def _run_gate_inner(steps, out, k, res, channels, batch, lr, ema_decay, mask_ratio, mask_fn,
                    num_sample_steps, loss_floor, mse_ratio_bound, device) -> dict:
    import torch

    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params
    from maskdit_tpu_torch.train.trainer import Trainer

    out = out or tempfile.mkdtemp(prefix="torch_overfit_gate_")
    os.makedirs(out, exist_ok=True)
    data_root, targets = build_fixture(out, k, res, channels)
    cfg = gate_config(data_root, res, channels, k, batch, lr, steps, ema_decay, mask_ratio,
                      mask_fn)
    trainer = Trainer(cfg, results_dir=out, seed=0, num_workers=1, device=device)
    final_step = trainer.train()

    # the loss curve from the metrics stream the trainer logs
    with open(os.path.join(trainer.exp_dir, "metrics.jsonl")) as fh:
        losses = [r["train/loss"] for r in map(json.loads, fh) if "train/loss" in r]
    loss_start = float(np.mean(losses[:2])) if len(losses) >= 2 else losses[0]
    loss_end = float(np.mean(losses[-3:]))

    # each class from the EMA weights (deterministic Heun, no CFG), in fp32
    m = cfg["model"]
    model = create_model("edm", img_resolution=res, img_channels=channels, num_classes=k,
                         model_type=m["model_type"], use_decoder=m["use_decoder"],
                         mae_loss_coef=m["mae_loss_coef"], dtype=torch.float32)
    model.load_state_dict(trainer.state.named(trainer.state.ema))
    model = model.to(device).eval()
    samples = np.stack([
        generate_with_params(model, [cls], None, SamplerConfig(num_steps=num_sample_steps),
                             class_idx=cls, max_batch_size=1)[0]
        for cls in range(k)
    ]).astype(np.float32)  # (k, C, res, res), model space

    scaled = targets * 0.18215  # the space the model was trained in
    flat_s, flat_t = samples.reshape(k, -1), scaled.reshape(k, -1)
    mse = ((flat_s[:, None, :] - flat_t[None, :, :]) ** 2).mean(-1)
    nn = mse.argmin(axis=1)
    on_target = float(np.mean(np.diag(mse)))
    off_target = float(np.mean(mse[~np.eye(k, dtype=bool)]))
    identity = bool((nn == np.arange(k)).all())
    return {
        "steps": int(final_step),
        "loss_start": round(loss_start, 4),
        "loss_end": round(loss_end, 4),
        "nn_match": f"{int((nn == np.arange(k)).sum())}/{k}",
        "on_target_mse": on_target,
        "off_target_mse": off_target,
        "mse_ratio": float(on_target / max(off_target, 1e-12)),
        "passed": bool(identity and loss_end < loss_floor
                       and on_target < mse_ratio_bound * off_target),
        "device": device,
        "reader": trainer.data_source,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("overfit-and-sample trainability gate (PyTorch port)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--k", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--mask_ratio", type=float, default=0.5)
    p.add_argument("--mask_fn", type=str, default="cosine2")
    p.add_argument("--sample_steps", type=int, default=18)
    p.add_argument("--device", type=str, default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    verdict = run_gate(steps=args.steps, out=args.out, k=args.k, batch=args.batch, lr=args.lr,
                       mask_ratio=args.mask_ratio, mask_fn=args.mask_fn,
                       num_sample_steps=args.sample_steps, device=args.device)
    print(json.dumps(verdict), flush=True)
    return verdict


if __name__ == "__main__":
    sys.exit(0 if main()["passed"] else 1)
