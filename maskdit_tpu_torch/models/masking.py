"""Token masking and unmasking for the masked training forward.

Counterpart of maskdit_tpu/models/masking.py (reference: models/maskdit.py:
88-163). A per-sample shuffle comes from an argsort of uniform noise; the
kept tokens are gathered into a dense (N, len_keep, D) buffer, so the
encoder runs at the packed length. The mask is derived from the rank
permutation: position p is dropped iff its rank ``ids_restore[p]`` is at
least ``len_keep``. Pad-to-max masking (``padded_random_mask``,
``scatter_tokens_padded``) keeps a fixed ``len_max`` tokens of which the
first ``len_keep`` are valid: attention masks out the tail
(``ops/attention.mha_reference``'s ``kv_valid``) and the scatter routes only
ranks below ``len_keep`` back, so it computes the packed function.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MaskInfo(NamedTuple):
    """mask: (N, L) float, 0 = keep, 1 = drop (reference convention);
    ids_keep: (N, len_keep) int64, the kept positions in shuffle order;
    ids_restore: (N, L) int64, the rank of each position in the shuffle;
    len_keep: None for the packed path (the width of ids_keep), or for
    pad-to-max a 0-d int64 tensor, the count of valid leading columns of
    ids_keep, which is ``len_max`` wide."""

    mask: torch.Tensor
    ids_keep: torch.Tensor
    ids_restore: torch.Tensor
    len_keep: Optional[torch.Tensor] = None


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


def padded_len_keep(length: int, mask_ratio, device: torch.device | str = "cpu") -> torch.Tensor:
    """The pad-to-max step's kept count, floor(L * (1 - ratio)) in fp32 as
    the JAX loss forms it from a traced ratio (maskdit_tpu/train/loss.py:
    107-110), as a 0-d int64 tensor."""
    ratio = torch.as_tensor(mask_ratio, dtype=torch.float32, device=device)
    return torch.floor(length * (1.0 - ratio)).to(torch.int64)


def padded_random_mask(
    batch: int, length: int, len_max: int, len_keep: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cpu",
) -> MaskInfo:
    """Pad-to-max masks (JAX masking.py:67-95): the shuffle of
    ``random_mask`` (the same draw), ``ids_keep`` its first ``len_max``
    positions, of which the first ``len_keep`` are kept and the rest are
    padding."""
    len_keep = torch.as_tensor(len_keep, dtype=torch.int64, device=device)
    noise = torch.rand((batch, length), generator=generator, device=device)
    ids_shuffle = torch.argsort(noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    mask = (ids_restore >= len_keep).float()
    return MaskInfo(mask=mask, ids_keep=ids_shuffle[:, :len_max], ids_restore=ids_restore,
                    len_keep=len_keep)


def gather_tokens(x: torch.Tensor, ids_keep: torch.Tensor) -> torch.Tensor:
    """(N, L, D) -> (N, len_keep, D), the kept tokens in shuffle order
    (reference: mask_out_token, maskdit.py:116-127)."""
    index = ids_keep.long()[..., None].expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, index)


def scatter_tokens(
    x: torch.Tensor, ids_restore: torch.Tensor, mask_token: torch.Tensor, extras: int = 0,
) -> torch.Tensor:
    """(N, extras + len_keep, D) -> (N, extras + L, D), holes filled with
    ``mask_token`` (reference: unmask_tokens, maskdit.py:157-163).

    As the JAX package writes it (masking.py:103-124): the kept tokens and
    the broadcast mask tokens are concatenated, then gathered by
    ``ids_restore``. The ``extras`` leading tokens (the class token) are
    carried past the gather unshuffled. The gradient reaches ``mask_token``
    through the gather.
    """
    n, t, d = x.shape
    mask_toks = mask_token.to(x.dtype).expand(n, ids_restore.shape[1] + extras - t, d)
    index = ids_restore.long()[..., None].expand(-1, -1, d)
    out = torch.gather(torch.cat([x[:, extras:], mask_toks], dim=1), 1, index)
    return torch.cat([x[:, :extras], out], dim=1) if extras else out


def scatter_tokens_padded(
    x: torch.Tensor, ids_restore: torch.Tensor, mask_token: torch.Tensor,
    len_keep: torch.Tensor, extras: int = 0,
) -> torch.Tensor:
    """(N, extras + len_max, D), of which the first ``len_keep`` tokens
    after the ``extras`` leading ones are valid -> (N, extras + L, D) (JAX
    masking.py:127-149): a position whose rank is at least ``len_keep`` gets
    ``mask_token``, including ranks that point into the padded tail, so the
    tail never reaches the output; the leading tokens are carried past."""
    n, t, d = x.shape
    body = x[:, extras:]
    pool = torch.cat([body, mask_token.to(x.dtype).expand(n, 1, d)], dim=1)  # the token last
    index = torch.where(ids_restore < len_keep, ids_restore, t - extras).long()
    out = torch.gather(pool, 1, index[..., None].expand(-1, -1, d))
    return torch.cat([x[:, :extras], out], dim=1) if extras else out
