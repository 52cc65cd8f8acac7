"""Checkpoints: reference-checkpoint import and the trainer's own saves.

Counterpart of maskdit_tpu/utils/ckpt.py. A released ``.pt`` file
(reference train.py:259-268) holds ``{model, ema, opt, args}``; sampling
takes ``ema``. Its keys are the port's own, so the state dict loads into
``EDMPrecond`` directly. A finetune imports ``model`` and ``ema`` into a
fresh train state non-strictly (``graft_params``, the JAX package's
``strict=False`` import): a parameter the file lacks, such as the mask
token an unmasked run never trained, keeps its initialisation. The trainer saves ``{model, ema, opt, step}`` in
the same layout with ``torch.save`` (``opt`` is Adam's count, mu and nu
under the parameter keys), one file per step, and resumes from the newest.
Orbax checkpoints belong to the JAX package and are not read here.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch
import torch.nn as nn

# fixed sin-cos tables: the port recomputes them (non-persistent buffers)
RECOMPUTED_KEYS = ("model.pos_embed", "model.decoder_pos_embed")


def load_reference_states(path: str, keys=("model", "ema")) -> dict[str, dict[str, torch.Tensor]]:
    """The state dicts ``keys`` of a reference ``.pt`` file, read once, on
    the CPU, with torch.compile's ``_orig_mod.`` prefix stripped."""
    # the file also pickles the training run's args, so it is not a
    # weights-only archive
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {key: {k.replace("_orig_mod.", ""): v for k, v in ckpt[key].items()}
            for key in keys}


def load_reference_checkpoint(path: str, use_ema: bool = True) -> dict[str, torch.Tensor]:
    """The ``ema`` (or ``model``) state dict of a reference ``.pt`` file."""
    key = "ema" if use_ema else "model"
    return load_reference_states(path, (key,))[key]


def graft_params(target: dict[str, torch.Tensor], loaded: dict[str, torch.Tensor]) -> list[str]:
    """Overlay ``loaded`` onto ``target``'s tensors in place and return the
    keys of ``target`` that ``loaded`` lacks, which keep their values.

    The JAX package's non-strict import (``load_reference_checkpoint(...,
    strict=False)`` + ``graft_params``, maskdit_tpu/utils/ckpt.py:80-133;
    reference train.py:150-151): keys ``target`` lacks are dropped, and a
    shape that differs raises ``ValueError`` naming the key (never a
    reshape of a tensor with the same element count)."""
    with torch.no_grad():
        for k, v in target.items():
            if k not in loaded:
                continue
            src = loaded[k]
            if tuple(src.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: ckpt {tuple(src.shape)} vs "
                                 f"model {tuple(v.shape)}")
            v.copy_(src)
    return sorted(set(target) - set(loaded))


def load_into(model: nn.Module, state: dict[str, torch.Tensor], strict: bool = True) -> None:
    """Load ``state`` into ``model``; the recomputed pos-embed tables a
    checkpoint may carry are accepted and ignored (as the JAX
    ``convert_maskdit`` skips them)."""
    state = {k: v for k, v in state.items() if k not in RECOMPUTED_KEYS}
    model.load_state_dict(state, strict=strict)


_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """``<directory>/ckpt_<step>.pt`` files; keeps the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 4):
        self.directory = directory
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:07d}.pt")

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ckpt: dict[str, Any]) -> str:
        """Write atomically (a partial file never has a checkpoint's name)."""
        os.makedirs(self.directory, exist_ok=True)
        path = self.path(step)
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None) -> dict[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)
