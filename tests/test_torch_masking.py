"""The port's token masking against the JAX package's.

gather and scatter take injected ids and must agree exactly; the torch
draw of ``random_mask`` is checked for its properties only (threefry and
torch streams differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import masking as jax_masking
from maskdit_tpu_torch.models import masking

N, L, D = 3, 16, 5


def _ids(seed, ratio=0.5):
    rng = np.random.default_rng(seed)
    shuffle = np.argsort(rng.random((N, L)), axis=1)
    restore = np.argsort(shuffle, axis=1)
    keep = masking.len_keep_for(L, ratio)
    return shuffle[:, :keep].astype(np.int32), restore.astype(np.int32)


def test_len_keep_for_matches():
    for length in (16, 64, 256, 1024):
        for ratio in (0.0, 0.25, 0.5, 0.7, 0.75, 0.9):
            assert masking.len_keep_for(length, ratio) == jax_masking.len_keep_for(length, ratio)


def test_gather_tokens_matches_jax():
    x = np.random.default_rng(1).normal(size=(N, L, D)).astype(np.float32)
    ids_keep, _ = _ids(2)
    ours = masking.gather_tokens(torch.from_numpy(x), torch.from_numpy(ids_keep))
    theirs = jax_masking.gather_tokens(jnp.asarray(x), jnp.asarray(ids_keep))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("ratio", [0.5, 0.25])
def test_scatter_tokens_matches_jax(ratio):
    rng = np.random.default_rng(3)
    ids_keep, ids_restore = _ids(4, ratio)
    x = rng.normal(size=(N, ids_keep.shape[1], D)).astype(np.float32)
    tok = rng.normal(size=(1, 1, D)).astype(np.float32)
    ours = masking.scatter_tokens(
        torch.from_numpy(x), torch.from_numpy(ids_restore), torch.from_numpy(tok)
    )
    theirs = jax_masking.scatter_tokens(
        jnp.asarray(x), jnp.asarray(ids_restore), jnp.asarray(tok)
    )
    assert ours.shape == (N, L, D)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_scatter_inverts_gather_and_reaches_mask_token():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(N, L, D)).astype(np.float32))
    info = masking.random_mask(N, L, 0.5, torch.Generator().manual_seed(0))
    tok = torch.zeros(1, 1, D, requires_grad=True)
    back = masking.scatter_tokens(masking.gather_tokens(x, info.ids_keep), info.ids_restore, tok)
    kept = info.mask == 0
    torch.testing.assert_close(back[kept], x[kept], rtol=0, atol=0)
    assert (back[~kept] == 0).all()
    back.sum().backward()
    # each of the N * (L - len_keep) holes adds 1 to each feature
    torch.testing.assert_close(tok.grad, torch.full((1, 1, D), float(N * L // 2)))


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75])
def test_random_mask_properties(ratio):
    g = torch.Generator().manual_seed(7)
    info = masking.random_mask(N, L, ratio, g)
    keep = masking.len_keep_for(L, ratio)
    assert info.ids_keep.shape == (N, keep) and info.ids_restore.shape == (N, L)
    for row in range(N):
        restore = info.ids_restore[row]
        assert sorted(restore.tolist()) == list(range(L))  # a permutation
        torch.testing.assert_close(info.mask[row], (restore >= keep).float())
        assert int((info.mask[row] == 0).sum()) == keep
        # the kept positions are exactly those of rank < len_keep
        assert sorted(info.ids_keep[row].tolist()) == sorted(
            torch.nonzero(restore < keep).flatten().tolist()
        )
    # another seed draws another mask
    other = masking.random_mask(N, L, ratio, torch.Generator().manual_seed(8))
    assert not torch.equal(info.ids_restore, other.ids_restore)
