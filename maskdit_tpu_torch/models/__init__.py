from maskdit_tpu_torch.models.dit import DIT_CONFIGS, MaskDiT, create_dit
from maskdit_tpu_torch.models.precond import (
    PRECOND_MODELS,
    EDMPrecond,
    create_model,
)

__all__ = [
    "DIT_CONFIGS",
    "MaskDiT",
    "create_dit",
    "EDMPrecond",
    "PRECOND_MODELS",
    "create_model",
]
