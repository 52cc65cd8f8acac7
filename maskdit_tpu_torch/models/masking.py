"""Token masking and unmasking for the masked training forward.

Counterpart of maskdit_tpu/models/masking.py (reference: models/maskdit.py:
88-163). A per-sample shuffle comes from an argsort of uniform noise; the
kept tokens are gathered into a dense (N, len_keep, D) buffer, so the
encoder runs at the packed length. The mask is derived from the rank
permutation: position p is dropped iff its rank ``ids_restore[p]`` is at
least ``len_keep``. The pad-to-max variants of the JAX package are not
ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MaskInfo(NamedTuple):
    """mask: (N, L) float, 0 = keep, 1 = drop (reference convention);
    ids_keep: (N, len_keep) int64, the kept positions in shuffle order;
    ids_restore: (N, L) int64, the rank of each position in the shuffle."""

    mask: torch.Tensor
    ids_keep: torch.Tensor
    ids_restore: torch.Tensor


def len_keep_for(length: int, mask_ratio: float) -> int:
    """Number of tokens the encoder keeps (reference: maskdit.py:101)."""
    return int(length * (1.0 - float(mask_ratio)))


def random_mask(
    batch: int, length: int, mask_ratio: float,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
) -> MaskInfo:
    """Per-sample random masks (reference: get_mask, maskdit.py:88-113):
    the shuffle is the argsort of U[0, 1) noise and the first ``len_keep``
    ranks are kept."""
    len_keep = len_keep_for(length, mask_ratio)
    noise = torch.rand((batch, length), generator=generator, device=device)
    ids_shuffle = torch.argsort(noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = (ids_restore >= len_keep).float()
    return MaskInfo(mask=mask, ids_keep=ids_keep, ids_restore=ids_restore)


def gather_tokens(x: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
    """(N, L, D) -> (N, len_keep, D), the kept tokens in shuffle order
    (reference: mask_out_token, maskdit.py:116-127)."""
    index = ids_keep.long()[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, index)


def scatter_tokens(
    x: torch.Tensor, ids_restore: torch.Tensor, mask_token: torch.Tensor
) -> torch.Tensor:
    """(N, len_keep, D) -> (N, L, D), holes filled with ``mask_token``
    (reference: unmask_tokens, maskdit.py:157-163).

    As the JAX package writes it: the kept tokens and the broadcast mask
    tokens are concatenated, then gathered by ``ids_restore``. The gradient
    reaches ``mask_token`` through the gather. The JAX package's leading
    ``extras`` tokens (class token, external features) are not ported.
    """
    n, t, d = x.shape
    mask_toks = mask_token.to(x.dtype).expand(n, ids_restore.shape[1] - t, d)
    index = ids_restore.long()[..., None].expand(-1, -1, d)
    return torch.gather(torch.cat([x, mask_toks], dim=1), 1, index)
