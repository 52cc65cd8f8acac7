"""Exact fp32 for the evaluation path's convolutions and products.

The JAX package runs the VAE and the InceptionV3 in fp32. On a CUDA card
PyTorch lets cuDNN convolutions (and, where the caller turned it on, cuBLAS
matmuls) round their inputs to TF32, which moves decoded PNGs, detector
features and precision-recall decisions. The modules that must match the
reference wrap their own call in ``exact_fp32()``, so their results do not
depend on the caller's global flags.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block;
    the caller's settings are restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
