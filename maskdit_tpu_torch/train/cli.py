"""Training CLI of the port (counterpart of the repo's train.py).

``python -m maskdit_tpu_torch.train`` runs ``main`` (through the package's
``__main__``), which is also ``maskdit_tpu_torch.train.main``. Usage:
  python -m maskdit_tpu_torch.train --config configs/train/imagenet256-latent.yaml \
      [--results_dir results] [--ckpt_path X.pt] [--max_steps N] \
      [--device cuda] [overrides a.b=c ...]

The config is the JAX package's YAML schema, or a ``.json`` file of the
same schema (the card's machine need not have PyYAML). One device, rank 0
of world 1; the mesh, coordinator and in-training eval flags of the JAX
CLI are not ported. Only ``data.category: synthetic`` is read so far.
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
    from maskdit_tpu_torch.utils.logging import parse_str_none

    parser = argparse.ArgumentParser("training parameters")
    parser.add_argument("--config", type=str, required=True, help="YAML or JSON config")
    parser.add_argument("--results_dir", type=str, default="results")
    parser.add_argument("--ckpt_path", type=parse_str_none, default=None,
                        help="reference .pt checkpoint to start from")
    parser.add_argument("--global_seed", type=int, default=0)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override config.train.max_num_steps")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    parser.add_argument("overrides", nargs="*", help="config overrides: a.b.c=value")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict[str, Any]:
    """Run the CLI; returns {'step': last step, 'exp_dir': ..., 'history':
    the log records (one per logged window)}."""
    from maskdit_tpu_torch.utils.logging import Logger
    from maskdit_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.overrides)
    validate(cfg)
    trainer = Trainer(
        cfg,
        results_dir=args.results_dir,
        seed=args.global_seed,
        ckpt_path=args.ckpt_path,
        num_workers=args.num_workers,
        max_steps_override=args.max_steps,
        device=args.device,
    )
    with Logger(os.path.join(trainer.exp_dir, "log.txt"), "a+"):
        step = trainer.train()
        print("Done!")
    return {"step": step, "exp_dir": trainer.exp_dir, "history": trainer.history}


if __name__ == "__main__":
    main()
