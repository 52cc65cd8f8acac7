"""Sampling CLI of the port (counterpart of the repo's generate.py).

Usage:
  python -m maskdit_tpu_torch.generate --ckpt_path <ckpt.pt> --outdir out \
      --seeds 0-63 [--class_idx 207] [--cfg_scale 1.5] [--num_steps 40] \
      [--config configs/test/maskdit-256.yaml] \
      [--pretrained_path assets/stable_diffusion/autoencoder_kl.pth] ...

Class-sample mode (reference generate.py:39-60): ``--label_dict L.json
--class_idx N --results_dir R`` writes into ``R/<class name>/`` instead of
``--outdir``. ``--subdirs`` puts the PNGs under thousand-seed folders.

Loads the EMA weights of a reference ``.pt`` checkpoint, samples with the
EDM (or ablation) sampler on ``--device`` (under ``python -m
torch.distributed.run`` each process samples its rank-strided batches of
the seeds on ``cuda:LOCAL_RANK``, rank 0 writes the log), decodes each
batch with the SD-VAE of ``--pretrained_path`` (the released
``autoencoder_kl.pth`` layout, fp32) and writes ``{seed:06d}.png``.
``--no_decode`` writes the latents of each batch as
``latents_<first seed>.npy`` instead. The model computes in bf16 unless
``--fp32``.

The model corners as the JAX CLI reads them (root generate.py:115-167,
240-266): ``--pad_cls_token``, ``--ext_feature_dim``, ``--use_encoder_feat``
(from ``--config``: ``model.pad_cls_token``, ``model.ext_feature_dim`` and
``model.self_cond``); with ``--feat_path`` (a feature LMDB) and
``--ext_feature_dim > 0`` each batch is conditioned on features drawn by
``--sample_mode``, with their own labels, so ``--class_idx`` is refused.

``--export_aot FILE`` (root generate.py:208-220) samples nothing: it exports
the whole sampler for a batch of ``--max_batch_size`` in the model's dtype
(``sampling/aot.py``; no VAE is built, ``--outdir`` is not needed), prints
the batch and the file's size, and returns.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from maskdit_tpu_torch.data.features import SAMPLE_MODES, retrieve_n_features
from maskdit_tpu_torch.models import DIT_CONFIGS, create_model
from maskdit_tpu_torch.parallel import dist
from maskdit_tpu_torch.sampling.generate import (
    SamplerConfig,
    generate_with_params,
    resolve_class_outdir,
)
from maskdit_tpu_torch.utils import config as config_lib
from maskdit_tpu_torch.utils.ckpt import load_into, load_reference_checkpoint
from maskdit_tpu_torch.utils.logging import Logger, parse_float_none, parse_int_list, str2bool
from maskdit_tpu_torch.utils.port import load_vae


class TimedVAE:
    """A VAE whose ``decode`` adds its device time to ``seconds``."""

    def __init__(self, vae, device: torch.device):
        self.vae, self.device, self.seconds = vae, device, 0.0

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        _synchronize(self.device)
        t0 = time.perf_counter()
        out = self.vae.decode(z)
        _synchronize(self.device)
        self.seconds += time.perf_counter() - t0
        return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("sampling parameters")
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="reference .pt checkpoint; its 'ema' weights are used")
    parser.add_argument("--outdir", type=str, default=None,
                        help="output dir; or use --label_dict/--results_dir")
    parser.add_argument("--config", type=str, default=None,
                        help="model config (YAML, or JSON of the same schema); "
                        "overrides the --model_type/... flags")
    parser.add_argument("--label_dict", type=str, default=None,
                        help="JSON {class_idx: [synset, class_name]}; with "
                        "--class_idx, samples go to <results_dir>/<class_name>")
    parser.add_argument("--results_dir", type=str, default="samples")
    parser.add_argument("--seeds", type=parse_int_list, default="0-63")
    parser.add_argument("--subdirs", action="store_true")
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
                        help="save raw latents as .npy instead of decoded PNGs")
    parser.add_argument("--pretrained_path", type=str,
                        default="assets/stable_diffusion/autoencoder_kl.pth",
                        help="SD-VAE weights (autoencoder_kl.pth layout) for the decode")
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--image_channels", type=int, default=4)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--model_type", type=str,
                        choices=list(DIT_CONFIGS), default="DiT-XL/2")
    parser.add_argument("--precond", type=str, default="edm", choices=["edm"])
    parser.add_argument("--use_decoder", type=str2bool, default=False)
    parser.add_argument("--pad_cls_token", type=str2bool, default=False)
    parser.add_argument("--mae_loss_coef", type=float, default=0)
    parser.add_argument("--ext_feature_dim", type=int, default=0)
    parser.add_argument("--use_encoder_feat", type=str2bool, default=False,
                        help="self-conditioning on the pooled encoder feature "
                        "(from --config: model.self_cond)")
    parser.add_argument("--feat_path", type=str, default="",
                        help="feature LMDB to draw external features from")
    parser.add_argument("--sample_mode", type=str, default="rand_full",
                        choices=list(SAMPLE_MODES))
    parser.add_argument("--use_strict_load", type=str2bool, default=True)
    parser.add_argument("--export_aot", type=str, default="",
                        help="instead of sampling, export the sampler (torch.export) for "
                        "batch --max_batch_size to this path and exit; reload with "
                        "maskdit_tpu_torch.ops.exported.load_sampler")
    parser.add_argument("--fp32", action="store_true",
                        help="run the denoiser in fp32 (parity mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {'images': n, 'seconds': t, 'decode_seconds':
    d}: t is the whole generation (sampling, the decode and the file writes;
    weights loaded, device synchronised at both ends), d the decode's part
    of it (0 with ``--no_decode``)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config is not None:
        # model hyperparameters from the config (reference generate.py:31-39)
        m = config_lib.load_file(args.config).model
        if m.precond != "edm":
            parser.error(f"precond '{m.precond}' is not ported (edm only)")
        args.model_type = m.model_type
        args.image_size = m.in_size
        args.image_channels = m.in_channels
        args.num_classes = m.num_classes
        args.precond = m.precond
        args.use_decoder = m.use_decoder
        args.mae_loss_coef = m.get("mae_loss_coef", 0)
        args.pad_cls_token = m.get("pad_cls_token", False)
        args.ext_feature_dim = m.get("ext_feature_dim", 0)
        # the reference reads model.self_cond, which no released config
        # defines: absent means False, as in the JAX CLI
        args.use_encoder_feat = m.get("self_cond", False)
    if args.label_dict is not None:
        if args.class_idx is None:
            parser.error("--label_dict requires --class_idx")
        args.outdir, class_name = resolve_class_outdir(
            args.label_dict, args.class_idx, args.results_dir)
        print(f"sampling class {args.class_idx} ({class_name}) into {args.outdir}")
    elif args.outdir is None and not args.export_aot:
        parser.error("one of --outdir or --label_dict is required")
    if args.feat_path and args.ext_feature_dim > 0 and args.class_idx is not None:
        parser.error("--class_idx cannot combine with --feat_path: retrieved feature rows "
                     "carry their own matching class labels")

    created = dist.init_distributed(device=args.device)
    try:
        if args.export_aot:
            return _export(args, dist.local_device(args.device))
        return _generate(args, dist.local_device(args.device))
    finally:
        if created:
            dist.shutdown()


def _build_model(args: argparse.Namespace, device: torch.device):
    model = create_model(
        "edm",
        img_resolution=args.image_size,
        img_channels=args.image_channels,
        num_classes=args.num_classes,
        model_type=args.model_type,
        use_decoder=args.use_decoder,
        mae_loss_coef=args.mae_loss_coef,
        pad_cls_token=args.pad_cls_token,
        ext_feature_dim=args.ext_feature_dim,
        use_encoder_feat=args.use_encoder_feat,
        dtype=torch.float32 if args.fp32 else torch.bfloat16,
    )
    load_into(model, load_reference_checkpoint(args.ckpt_path), strict=args.use_strict_load)
    model = model.to(device).eval()
    dist.mprint(f"loaded weights from {args.ckpt_path}")
    return model


def _sampler_config(args: argparse.Namespace) -> SamplerConfig:
    return SamplerConfig(
        num_steps=args.num_steps,
        cfg_scale=args.cfg_scale,
        S_churn=args.S_churn,
        solver=args.solver,
        discretization=args.discretization,
        schedule=args.schedule,
        scaling=args.scaling,
    )


def _export(args: argparse.Namespace, device: torch.device) -> dict:
    """``--export_aot``: the sampler for a batch of ``--max_batch_size``,
    exported by the main process; no VAE. Returns {'path', 'bytes',
    'seconds'} (the export and the write)."""
    from maskdit_tpu_torch.sampling.aot import export_sampler

    model = _build_model(args, device)
    t0 = time.perf_counter()
    if dist.is_main_process():
        export_sampler(model, _sampler_config(args), args.max_batch_size, args.export_aot)
    dist.barrier()
    seconds = time.perf_counter() - t0
    size = os.path.getsize(args.export_aot)
    dist.mprint(f"exported the sampler (batch {args.max_batch_size}, {size / 1e6:.1f} MB, "
                f"{seconds:.1f} s) to {args.export_aot}")
    return {"path": args.export_aot, "bytes": size, "seconds": seconds}


def _generate(args: argparse.Namespace, device: torch.device) -> dict:
    rank, world = dist.process_index(), dist.process_count()
    os.makedirs(args.outdir, exist_ok=True)
    log_file = os.path.join(args.outdir, "log.txt") if rank == 0 else None
    with Logger(log_file, "a+"):
        model = _build_model(args, device)
        vae = None
        if not args.no_decode:
            vae = TimedVAE(load_vae(args.pretrained_path).to(device), device)
            dist.mprint(f"loaded the VAE from {args.pretrained_path}")

        sampler_cfg = _sampler_config(args)
        feat_fn = None
        if args.feat_path and args.ext_feature_dim > 0:
            # each batch draws (feature, label) rows from the feature LMDB,
            # seeded by its first seed, so any rank / world split draws the
            # same rows for the same batch (JAX generate.py:240-258)
            feat_fn = lambda batch_seeds: retrieve_n_features(
                len(batch_seeds), args.feat_path, args.ext_feature_dim, args.num_classes,
                sample_mode=args.sample_mode, seed=int(batch_seeds[0]))
        what = "latents" if vae is None else "images"
        dist.mprint(f"generating {len(args.seeds)} {what} to {args.outdir} "
                    f"(cfg={args.cfg_scale}, steps={args.num_steps}, device={device}, "
                    f"{world} process{'es' if world > 1 else ''})")
        _synchronize(device)
        t0 = time.perf_counter()
        generate_with_params(
            model, args.seeds, args.outdir, sampler_cfg,
            class_idx=args.class_idx, max_batch_size=args.max_batch_size,
            save_latents=vae is None, vae=vae, rank=rank, world=world,
            subdirs=args.subdirs, feat_fn=feat_fn,
        )
        _synchronize(device)
        dist.barrier()  # every process's images are written
        seconds = time.perf_counter() - t0
        decode_seconds = 0.0 if vae is None else vae.seconds
        n = len(args.seeds)
        dist.mprint(f"Done: {n} {what} in {seconds:.3f} s ({n / seconds:.3f} {what}/s); "
                    f"sampling and writes {seconds - decode_seconds:.3f} s, "
                    f"decode {decode_seconds:.3f} s")
    return {"images": n, "seconds": seconds, "decode_seconds": decode_seconds}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    main()
