"""Plain multi-head attention, the math every attention path is held to.

Counterpart of maskdit_tpu/ops/attention.py::mha_reference: fp32 logits,
fp32 softmax, probabilities cast to the value dtype, fp32 accumulation,
output in q's dtype (the numerics of the reference's timm Attention under
AMP). The pad-to-max ``kv_valid`` mask is not ported (the training path
runs packed, without padding).
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q, k, v: (N, H, L, hd). Returns (N, H, L, hd) in q.dtype.

    ``scale`` defaults to hd ** -0.5. Operands are widened to fp32 before
    each product, which is exact for bf16, so both products accumulate in
    fp32 as the JAX version's ``preferred_element_type=float32`` does.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)
