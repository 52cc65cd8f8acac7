"""Training CLI of the port (counterpart of the repo's train.py).

``python -m maskdit_tpu_torch.train`` runs ``main`` (through the package's
``__main__``), which is also ``maskdit_tpu_torch.train.main``. Usage:
  python -m maskdit_tpu_torch.train --config configs/train/imagenet256-latent.yaml \
      [--results_dir results] [--ckpt_path X.pt [--use_strict_load False]] [--max_steps N] \
      [--device cuda] [overrides a.b=c ...]
  python -m torch.distributed.run --nproc_per_node 2 -m maskdit_tpu_torch.train ...

The config is the JAX package's YAML schema, or a ``.json`` file of the
same schema (the card's machine need not have PyYAML). Several processes
train data-parallel (``parallel/data_parallel.py``): launched by
``torch.distributed.run`` (env://), or each started with ``--coordinator
host:port --num_processes N --process_id i`` as the JAX CLI takes them.
Each process trains on ``cuda:LOCAL_RANK`` (``--device cuda``) or on the
device named; ``--dist_backend`` defaults to nccl on a card and gloo on
the CPU (gloo also lets processes share one card). The JAX CLI's
``--mesh`` (FSDP and tensor axes) is not ported.
``data.category`` is ``lmdb`` (the latent LMDB that
``python -m maskdit_tpu_torch.extract_latent`` writes), ``webdataset`` /
``wds`` (the shards of ``python -m maskdit_tpu_torch.lmdb2wds``, indexed, or
streamed with ``data.streaming=true``) or ``synthetic``. ``--enable_eval`` runs
the in-training FID after each checkpoint (``make_eval_hook``): the EMA
weights sample ``--eval_seeds``, the SD-VAE of ``--pretrained_path``
decodes them to PNGs, and their FID against ``eval.ref_path`` goes to
``metrics.jsonl`` as ``eval/fid``. ``--use_wandb`` also logs the metrics to
wandb under the config's ``wandb.entity`` / ``project`` / ``group`` (where
wandb is not importable, to ``metrics.jsonl`` only, with a warning).
``--debug_nans`` raises ``FloatingPointError`` at the first step whose loss,
gradient or updated parameters hold a NaN (the JAX CLI sets
``jax_debug_nans``, which checks for NaNs, not infinities); without it such
a run goes on. ``train.fused_adam=false``
trains with the staged Adam (``train/state.make_optimizer``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Optional, Sequence

from maskdit_tpu_torch.utils import config as config_lib

REQUIRED = (
    "data.resolution", "data.num_channels", "model.model_type", "model.precond",
    "model.mask_ratio", "train.batchsize", "train.lr", "train.max_num_steps",
    "log.log_every", "log.ckpt_every",
)


def load_config(path: str) -> dict[str, Any]:
    """A YAML or JSON config file as nested dicts."""
    return config_lib.load_file(path).to_container()


def parse_value(text: str) -> Any:
    """An override's value: None, a bool, a JSON number, list or string,
    or else the text itself."""
    if text in ("None", "none", "null"):
        return None
    if text in ("True", "true", "False", "false"):
        return text.lower() == "true"
    try:
        return json.loads(text)
    except ValueError:
        return text


def apply_overrides(cfg: dict, dotlist: Sequence[str]) -> dict:
    """Apply 'a.b.c=value' overrides in place."""
    for item in dotlist:
        key, sep, value = item.partition("=")
        if not sep:
            raise ValueError(f"override '{item}' is not of the form key=value")
        *path, last = key.strip().split(".")
        node = cfg
        for part in path:
            node = node.setdefault(part, {})
        node[last] = parse_value(value.strip())
    return cfg


def validate(cfg: dict) -> None:
    missing = []
    for path in REQUIRED:
        node: Any = cfg
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                missing.append(path)
                break
            node = node[part]
    if missing:
        raise KeyError(f"config is missing required keys: {missing}")


def build_parser() -> argparse.ArgumentParser:
    from maskdit_tpu_torch.fid import add_detector_args
    from maskdit_tpu_torch.utils.logging import parse_str_none, str2bool

    parser = argparse.ArgumentParser("training parameters")
    parser.add_argument("--config", type=str, required=True, help="YAML or JSON config")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--ckpt_path", type=parse_str_none, default=None,
                        help="reference .pt checkpoint to start from")
    # the reference's flag (train.py:116), parsed and, as in the JAX CLI, not
    # read: the Trainer imports a reference .pt non-strictly whatever it
    # says (maskdit_tpu/train/trainer.py:210)
    parser.add_argument("--use_strict_load", type=str2bool, default=True)
    parser.add_argument("--global_seed", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--use_wandb", action="store_true",
                        help="also log to wandb (the config's wandb.* keys)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="raise FloatingPointError at the first step whose loss, "
                        "gradient or updated parameters hold a NaN")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override config.train.max_num_steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda: cuda:LOCAL_RANK)")
    # the process group (reference utils.py:84-94; the JAX CLI's flags)
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rank 0's rendezvous host:port (else torch.distributed.run's)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="default: nccl on a card, gloo on the CPU")
    # in-training FID (reference: train.py:273-287)
    parser.add_argument("--enable_eval", action="store_true")
    parser.add_argument("--eval_seeds", type=str, default="0-9999")
    parser.add_argument("--cfg_scale", type=str, default="None")
    parser.add_argument("--num_steps", type=int, default=40)
    parser.add_argument("--max_batch_size", type=int, default=50)
    parser.add_argument("--num_expected", type=int, default=10000)
    parser.add_argument("--fid_batch_size", type=int, default=64)
    parser.add_argument("--pretrained_path", type=str,
                        default="assets/stable_diffusion/autoencoder_kl.pth")
    add_detector_args(parser)
    parser.add_argument("overrides", nargs="*", help="config overrides: a.b.c=value")
    return parser


def make_eval_hook(cfg: dict, args: argparse.Namespace):
    """``hook(step, ema) -> {'fid': value}``: the EMA weights sample
    ``--eval_seeds`` into ``<results_dir>/fid/edm-steps<N>-ckpt<step>_cfg<scale>``
    as PNGs, whose FID against ``eval.ref_path`` it returns (the JAX CLI's
    ``make_eval_hook``, train.py:40-105). Without ``--cfg_scale`` the
    config's first ``eval.cfg_scales`` entry is used, where it has one.
    Under several processes each samples its rank-strided seeds and the
    Inception statistics are summed over them."""
    from maskdit_tpu_torch.eval_latent import build_model
    from maskdit_tpu_torch.evals import fid as fid_lib
    from maskdit_tpu_torch.fid import build_detector
    from maskdit_tpu_torch.parallel.dist import barrier, local_device, process_count, process_index
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params
    from maskdit_tpu_torch.utils.logging import parse_float_none, parse_int_list
    from maskdit_tpu_torch.utils.port import load_vae

    seeds = parse_int_list(args.eval_seeds)
    cfg_scale = parse_float_none(args.cfg_scale)
    scales = cfg.get("eval", {}).get("cfg_scales")
    if cfg_scale is None and scales:
        cfg_scale = float(scales[0])
    device = local_device(args.device)
    eval_model = build_model(cfg["model"], device)
    vae = load_vae(args.pretrained_path).to(device)
    detector = build_detector(args, device)

    def hook(step: int, ema: dict) -> dict:
        eval_model.load_state_dict(ema)
        outdir = os.path.join(args.results_dir, "fid",
                              f"edm-steps{args.num_steps}-ckpt{step}_cfg{cfg_scale}")
        generate_with_params(eval_model, seeds, outdir,
                             SamplerConfig(num_steps=args.num_steps, cfg_scale=cfg_scale),
                             max_batch_size=args.max_batch_size, vae=vae,
                             rank=process_index(), world=process_count())
        barrier()  # every image is written before any is read
        return {"fid": fid_lib.calc(outdir, cfg["eval"]["ref_path"], args.num_expected,
                                    args.global_seed, args.fid_batch_size, detector)}

    return hook


def main(argv: Optional[Sequence[str]] = None) -> dict[str, Any]:
    """Run the CLI; returns {'step': last step, 'exp_dir': ..., 'history':
    the log records (one per logged window), 'state': the final
    TrainState}."""
    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.utils.logging import Logger
    from maskdit_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    validate(cfg)
    created = dist.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                    backend=args.dist_backend, device=args.device)
    try:
        trainer = Trainer(
            cfg,
            results_dir=args.results_dir,
            seed=args.global_seed,
            ckpt_path=args.ckpt_path,
            num_workers=args.num_workers,
            max_steps_override=args.max_steps,
            device=args.device,
            eval_hook=make_eval_hook(cfg, args) if args.enable_eval else None,
            use_wandb=args.use_wandb,
            debug_nans=args.debug_nans,
        )
        # rank 0 tees its output into log.txt
        log_file = os.path.join(trainer.exp_dir, "log.txt") if dist.is_main_process() else None
        with Logger(log_file, "a+"):
            step = trainer.train()
            dist.mprint("Done!")
    finally:
        if created:
            dist.shutdown()
    return {"step": step, "exp_dir": trainer.exp_dir, "history": trainer.history,
            "state": trainer.state}


if __name__ == "__main__":
    main()
