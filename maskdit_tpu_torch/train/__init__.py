from maskdit_tpu_torch.train.cli import main
from maskdit_tpu_torch.train.loss import EDMLoss, LOSSES, mae_loss, patchify, per_patch_mean
from maskdit_tpu_torch.train.schedules import bucket_ratio, get_mask_ratio_fn, lr_with_rampup
from maskdit_tpu_torch.train.state import (
    StepDraws,
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
    reparameterize_moments,
)

__all__ = [
    "EDMLoss", "LOSSES", "mae_loss", "patchify", "per_patch_mean",
    "bucket_ratio", "get_mask_ratio_fn", "lr_with_rampup", "StepDraws",
    "TrainState", "create_train_state", "make_optimizer", "make_train_step",
    "reparameterize_moments", "main",
]
