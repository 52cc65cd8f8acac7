"""Multi-head attention on (N, H, L, hd): the plain math and the dispatcher.

Counterpart of maskdit_tpu/ops/attention.py. ``mha_reference`` is the
math every attention path is held to: fp32 logits, fp32 softmax,
probabilities cast to the value dtype, fp32 accumulation, output in q's
dtype (the numerics of the reference's timm Attention under AMP). ``mha``
picks between it and ops/flash.py's kernels, and sends the pad-to-max
``kv_valid`` mask to it: no kernel takes that mask, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None, kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q, k, v: (N, H, L, hd). Returns (N, H, L, hd) in q.dtype.

    ``scale`` defaults to hd ** -0.5. Operands are widened to fp32 before
    each product, which is exact for bf16, so both products accumulate in
    fp32 as the JAX version's ``preferred_element_type=float32`` does.
    ``kv_valid`` (pad-to-max masking, a 0-d integer tensor): only keys at
    positions below it take part; the rows of queries past it are for the
    caller to discard (attention.py:22-50).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_valid is not None:
        cols = torch.arange(k.shape[2], device=k.device)
        logits = logits.masked_fill(cols >= kv_valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def mha(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    use_flash: Optional[bool] = None, kv_valid=None,
) -> torch.Tensor:
    """The dispatching entry point (attention.py:66-92): ``use_flash`` True
    runs ``flash.flash_mha`` (its kernels where ``flash.supports(L)``, else
    the plain math), False the plain math, None (auto) the kernels at
    L >= 1024 with L % 128 == 0. The JAX rule's other condition, a TPU
    backend, has no counterpart: the tensor's device picks between a kernel
    and its plain version inside ``flash_mha``. Any ``kv_valid`` goes to
    the plain math, whatever ``use_flash`` says (attention.py:78-82)."""
    if kv_valid is not None:
        return mha_reference(q, k, v, kv_valid=kv_valid)
    if use_flash is None:
        l = q.shape[2]
        use_flash = l >= 1024 and l % 128 == 0
    if use_flash:
        from maskdit_tpu_torch.ops import flash

        return flash.flash_mha(q, k, v)
    return mha_reference(q, k, v)
