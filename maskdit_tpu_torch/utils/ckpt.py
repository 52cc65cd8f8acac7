"""Reference-checkpoint import.

Counterpart of maskdit_tpu/utils/ckpt.py::load_reference_checkpoint. A
released ``.pt`` file (reference train.py:259-268) holds ``{model, ema,
opt, args}``; sampling takes ``ema``. Its keys are the port's own, so the
state dict loads into ``EDMPrecond`` directly. Orbax checkpoints belong to
the JAX package and are not read here.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# fixed sin-cos tables: the port recomputes them (non-persistent buffers)
RECOMPUTED_KEYS = ("model.pos_embed", "model.decoder_pos_embed")


def load_reference_checkpoint(path: str, use_ema: bool = True) -> dict[str, torch.Tensor]:
    """The ``ema`` (or ``model``) state dict of a reference ``.pt`` file, on
    the CPU, with torch.compile's ``_orig_mod.`` prefix stripped."""
    # the file also pickles the training run's args, so it is not a
    # weights-only archive
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["ema" if use_ema else "model"]
    return {k.replace("_orig_mod.", ""): v for k, v in state.items()}


def load_into(model: nn.Module, state: dict[str, torch.Tensor], strict: bool = True) -> None:
    """Load ``state`` into ``model``; the recomputed pos-embed tables a
    checkpoint may carry are accepted and ignored (as the JAX
    ``convert_maskdit`` skips them)."""
    state = {k: v for k, v in state.items() if k not in RECOMPUTED_KEYS}
    model.load_state_dict(state, strict=strict)
