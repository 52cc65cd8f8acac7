"""Mask-ratio schedules, ratio bucketing and the learning-rate warmup.

Counterpart of maskdit_tpu/train/schedules.py (reference: train_utils/
helper.py:9-27 and train.py:223-225), on Python floats and ints. The
shipped 'cos4' spelling is accepted beside 'cosine4'.
"""

from __future__ import annotations

import math
from typing import Callable

MaskRatioFn = Callable[[float], float]

_VALID = (
    "constant", "linear", "exp",
    "cosine2", "cosine3", "cosine4", "cosine5", "cosine6",
)


def get_mask_ratio_fn(
    name: str = "constant", ratio_scale: float = 0.5, ratio_min: float = 0.0
) -> MaskRatioFn:
    """Progress in [0, 1] -> mask ratio (reference: helper.py:9-27)."""
    name = name.strip()
    if name.startswith("cos") and not name.startswith("cosine"):
        name = "cosine" + name[3:]
    if name not in _VALID:
        raise ValueError(f"unknown mask ratio function '{name}' (valid: {_VALID})")
    span = ratio_scale - ratio_min
    if name == "constant":
        return lambda x: ratio_scale
    if name == "linear":
        return lambda x: span * x + ratio_min
    if name == "exp":
        return lambda x: span * math.exp(-x * 7) + ratio_min
    power = int(name[len("cosine"):])
    return lambda x: span * math.cos(math.pi * x / 2) ** power + ratio_min


def bucket_ratio(ratio: float, length: int, granularity: int = 16) -> float:
    """Quantise a mask ratio so that len_keep is a multiple of
    ``granularity`` tokens: one train step per bucket, not per value."""
    len_keep = int(length * (1.0 - ratio))
    len_keep = max(granularity, (len_keep // granularity) * granularity)
    len_keep = min(len_keep, length)
    return 1.0 - len_keep / length


def lr_with_rampup(step: int, base_lr: float, global_batch_size: int,
                   rampup_kimg: float) -> float:
    """lr = base * min(images seen / (rampup_kimg * 1000), 1)
    (reference: train.py:223-225); ``step`` is the steps taken so far."""
    frac = step * (global_batch_size / max(rampup_kimg * 1000.0, 1e-8))
    return base_lr * min(frac, 1.0)
