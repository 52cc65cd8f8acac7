"""Evaluation CLI of the port (counterpart of the repo's eval_latent.py):
checkpoint -> samples -> PNGs -> FID.

  python -m maskdit_tpu_torch.eval_latent --config configs/test/maskdit-256.yaml \
      --ckpt_path <ckpt.pt> --cfg_scale 1.5 --num_steps 40 \
      --detector_path assets/pt_inception-2015-12-05.pth

Loads the EMA weights of a reference ``.pt`` checkpoint into the config's
model (bf16 compute), samples ``--seeds`` with the EDM sampler, decodes them
with the SD-VAE of ``--pretrained_path`` into
``<outdir>/edm-steps<N>-cfg<scale>/{seed:06d}.png``, then computes the FID
of that folder against ``eval.ref_path`` of the config (skipped with
``--skip_fid``). On ``--device`` (default cuda). Under ``python -m
torch.distributed.run`` each process samples its rank-strided seeds on
``cuda:LOCAL_RANK``, and the Inception statistics are summed over the
processes (maskdit_tpu's eval_latent.py:52, 94); rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from maskdit_tpu_torch.evals import fid as fid_lib
from maskdit_tpu_torch.fid import add_detector_args, build_detector
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.parallel import dist
from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params
from maskdit_tpu_torch.utils import config as config_lib
from maskdit_tpu_torch.utils.ckpt import load_into, load_reference_checkpoint
from maskdit_tpu_torch.utils.logging import parse_float_none, parse_int_list
from maskdit_tpu_torch.utils.port import load_vae


def build_model(model_cfg, device) -> EDMPrecond:
    """The sampling model of a config's ``model`` section (a dict or a
    config node), in bf16 compute, on ``device``, in eval mode. It has the
    config's class token and feature embedder, so a trained state dict
    loads strictly; it samples without features (no feature LMDB is
    given), as the JAX evaluation does."""
    if model_cfg.get("precond", "edm") != "edm":
        raise NotImplementedError(f"precond '{model_cfg['precond']}' is not ported (edm only)")
    model = create_model(
        "edm",
        img_resolution=model_cfg["in_size"],
        img_channels=model_cfg["in_channels"],
        num_classes=model_cfg["num_classes"],
        model_type=model_cfg["model_type"],
        use_decoder=model_cfg["use_decoder"],
        mae_loss_coef=model_cfg.get("mae_loss_coef", 0),
        pad_cls_token=model_cfg.get("pad_cls_token", False),
        ext_feature_dim=model_cfg.get("ext_feature_dim", 0),
        dtype=torch.bfloat16,
    )
    return model.to(device).eval()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {'outdir': the PNG folder, 'seconds': the
    generation's, 'fid': the value or None with --skip_fid}."""
    parser = argparse.ArgumentParser("evaluation parameters")
    parser.add_argument("--config", type=str, required=True, help="YAML or JSON config")
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--outdir", type=str, default="eval_out")
    parser.add_argument("--seeds", type=parse_int_list, default="0-49999")
    parser.add_argument("--cfg_scale", type=parse_float_none, default=None)
    parser.add_argument("--num_steps", type=int, default=40)
    parser.add_argument("--max_batch_size", type=int, default=50)
    parser.add_argument("--num_expected", type=int, default=50000)
    parser.add_argument("--fid_batch_size", type=int, default=64)
    parser.add_argument("--global_seed", type=int, default=0)
    parser.add_argument("--pretrained_path", type=str,
                        default="assets/stable_diffusion/autoencoder_kl.pth")
    parser.add_argument("--skip_fid", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    add_detector_args(parser)
    args = parser.parse_args(argv)

    cfg = config_lib.load_file(args.config)
    created = dist.init_distributed(device=args.device)
    try:
        device = dist.local_device(args.device)
        model = build_model(cfg.model, device)
        load_into(model, load_reference_checkpoint(args.ckpt_path), strict=True)
        dist.mprint(f"loaded EMA weights from {args.ckpt_path}")
        vae = load_vae(args.pretrained_path).to(device)

        outdir = os.path.join(args.outdir, f"edm-steps{args.num_steps}-cfg{args.cfg_scale}")
        t0 = time.perf_counter()
        generate_with_params(model, args.seeds, outdir,
                             SamplerConfig(num_steps=args.num_steps, cfg_scale=args.cfg_scale),
                             max_batch_size=args.max_batch_size, vae=vae,
                             rank=dist.process_index(), world=dist.process_count())
        dist.barrier()  # every image is written before any is read
        seconds = time.perf_counter() - t0
        dist.mprint(f"generation took {seconds:.1f}s")

        value = None
        if not args.skip_fid:
            value = fid_lib.calc(outdir, cfg.eval.ref_path, args.num_expected, args.global_seed,
                                 args.fid_batch_size, build_detector(args, device))
            dist.mprint(f"cfg_scale: {args.cfg_scale} FID: {value:.4f}")
    finally:
        if created:
            dist.shutdown()
    return {"outdir": outdir, "seconds": seconds, "fid": value}


if __name__ == "__main__":
    main()
