"""Sampling CLI of the port (counterpart of the repo's generate.py).

Usage:
  python -m maskdit_tpu_torch.generate --ckpt_path <ckpt.pt> --outdir out \
      --seeds 0-63 --no_decode [--class_idx 207] [--cfg_scale 1.5] \
      [--num_steps 40] [--config configs/test/maskdit-256.yaml] ...

Loads the EMA weights of a reference ``.pt`` checkpoint, samples with the
EDM (or ablation) sampler on one device, rank 0 of world 1, and writes the
latents of each batch as ``latents_<first seed>.npy``. Decoding to PNGs
waits for the VAE's port, so ``--no_decode`` is required for now. The
model computes in bf16 unless ``--fp32``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from maskdit_tpu_torch.models import DIT_CONFIGS, check_model_keys, create_model
from maskdit_tpu_torch.sampling.generate import (
    VAE_NOT_PORTED,
    SamplerConfig,
    generate_with_params,
)
from maskdit_tpu_torch.utils import config as config_lib
from maskdit_tpu_torch.utils.ckpt import load_into, load_reference_checkpoint
from maskdit_tpu_torch.utils.logging import Logger, parse_float_none, parse_int_list, str2bool


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("sampling parameters")
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="reference .pt checkpoint; its 'ema' weights are used")
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--config", type=str, default=None,
                        help="model config (YAML, or JSON of the same schema); "
                        "overrides the --model_type/... flags")
    parser.add_argument("--seeds", type=parse_int_list, default="0-63")
    parser.add_argument("--class_idx", type=int, default=None)
    parser.add_argument("--max_batch_size", type=int, default=64)
    parser.add_argument("--cfg_scale", type=parse_float_none, default=None)
    parser.add_argument("--num_steps", type=int, default=18)
    parser.add_argument("--S_churn", type=int, default=0)
    parser.add_argument("--solver", type=str, default=None,
                        choices=["euler", "heun"])
    parser.add_argument("--discretization", type=str, default=None,
                        choices=["vp", "ve", "iddpm", "edm"])
    parser.add_argument("--schedule", type=str, default=None,
                        choices=["vp", "ve", "linear"])
    parser.add_argument("--scaling", type=str, default=None,
                        choices=["vp", "none"])
    parser.add_argument("--no_decode", action="store_true",
                        help="save raw latents as .npy (required until the "
                        "VAE is ported)")
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--image_channels", type=int, default=4)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--model_type", type=str,
                        choices=list(DIT_CONFIGS), default="DiT-XL/2")
    parser.add_argument("--use_decoder", type=str2bool, default=False)
    parser.add_argument("--mae_loss_coef", type=float, default=0)
    parser.add_argument("--use_strict_load", type=str2bool, default=True)
    parser.add_argument("--fp32", action="store_true",
                        help="run the denoiser in fp32 (parity mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {'images': n, 'seconds': t} for the sampling
    itself (weights loaded, device synchronised at both ends)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config is not None:
        # model hyperparameters from the config (reference generate.py:31-39)
        m = config_lib.load_file(args.config).model
        if m.precond != "edm":
            parser.error(f"precond '{m.precond}' is not ported (edm only)")
        check_model_keys(m)
        args.model_type = m.model_type
        args.image_size = m.in_size
        args.image_channels = m.in_channels
        args.num_classes = m.num_classes
        args.use_decoder = m.use_decoder
        args.mae_loss_coef = m.get("mae_loss_coef", 0)
    if not args.no_decode:
        raise NotImplementedError(VAE_NOT_PORTED)

    os.makedirs(args.outdir, exist_ok=True)
    device = torch.device(args.device)
    with Logger(os.path.join(args.outdir, "log.txt"), "a+"):
        model = create_model(
            "edm",
            img_resolution=args.image_size,
            img_channels=args.image_channels,
            num_classes=args.num_classes,
            model_type=args.model_type,
            use_decoder=args.use_decoder,
            mae_loss_coef=args.mae_loss_coef,
            dtype=torch.float32 if args.fp32 else torch.bfloat16,
        )
        load_into(model, load_reference_checkpoint(args.ckpt_path),
                  strict=args.use_strict_load)
        model = model.to(device).eval()
        print(f"loaded weights from {args.ckpt_path}")

        sampler_cfg = SamplerConfig(
            num_steps=args.num_steps,
            cfg_scale=args.cfg_scale,
            S_churn=args.S_churn,
            solver=args.solver,
            discretization=args.discretization,
            schedule=args.schedule,
            scaling=args.scaling,
        )
        print(f"generating {len(args.seeds)} latents to {args.outdir} "
              f"(cfg={args.cfg_scale}, steps={args.num_steps}, device={device})")
        _synchronize(device)
        t0 = time.perf_counter()
        generate_with_params(
            model, args.seeds, args.outdir, sampler_cfg,
            class_idx=args.class_idx, max_batch_size=args.max_batch_size,
            save_latents=True,
        )
        _synchronize(device)
        seconds = time.perf_counter() - t0
        print(f"Done: {len(args.seeds)} latents in {seconds:.3f} s")
    return {"images": len(args.seeds), "seconds": seconds}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
