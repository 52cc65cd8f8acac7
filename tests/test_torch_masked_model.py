"""The port's masked training forward of EDMPrecond against the JAX one.

Both run fp32 on the CPU at the tiny dims of the ``tiny_dit`` fixture, with
the same weights (carried across by ``state_dict_from_flax``) and the same
injected ``MaskInfo`` at mask ratio 0.5: the encoder sees 8 of 16 tokens,
the decoder gets them back with the learned mask token (MAE loss on) or a
zero token (off), or, without a decoder, the final layer's output is
scattered with zeros. The bound is that of tests/test_torch_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.models.masking import MaskInfo, len_keep_for
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_model import patch_tiny_port

ATOL = 3e-5
RES, CIN, K, N = 8, 4, 6, 3
L = (RES // 2) ** 2
VARIANTS = {"decoder_mae": (True, 0.1), "decoder_zero_token": (True, 0.0),
            "no_decoder": (False, 0.0)}


def make_pair(use_decoder, mae_loss_coef, seed):
    kw = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
              use_decoder=use_decoder, mae_loss_coef=mae_loss_coef)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **kw)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
            mask_ratio=0.5, train=True,
        )
    )["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32), shapes
    )
    model = create_model("edm", dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_flax(params))
    return jax_model, params, model


@pytest.fixture(scope="module")
def pairs(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    yield {name: make_pair(*v, seed=i) for i, (name, v) in enumerate(VARIANTS.items())}
    mp.undo()


def mask_arrays(seed, ratio=0.5, n=N):
    rng = np.random.default_rng(seed)
    shuffle = np.argsort(rng.random((n, L)), axis=1).astype(np.int32)
    restore = np.argsort(shuffle, axis=1).astype(np.int32)
    keep = len_keep_for(L, ratio)
    mask = (restore >= keep).astype(np.float32)
    return mask, shuffle[:, :keep], restore


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, CIN, RES, RES)).astype(np.float32)
    sigma = np.array([0.3, 1.1, 6.0], np.float32)
    y = np.eye(K, dtype=np.float32)[[1, 4, 0]]
    return x, sigma, y


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_masked_forward_matches_jax(pairs, variant):
    jax_model, params, model = pairs[variant]
    x, sigma, y = inputs(seed=10)
    mask, ids_keep, ids_restore = mask_arrays(seed=11)
    theirs = jax_model.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(y),
        mask_ratio=0.5, train=True,
        mask_info=JaxMaskInfo(jnp.asarray(mask), jnp.asarray(ids_keep), jnp.asarray(ids_restore)),
    )
    info = MaskInfo(*(torch.from_numpy(a) for a in (mask, ids_keep, ids_restore)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y),
                     mask_ratio=0.5, mask_info=info, train=True)
    assert ours["x"].shape == (N, CIN, RES, RES)
    np.testing.assert_array_equal(ours["mask"].numpy(), np.asarray(theirs["mask"]))
    np.testing.assert_allclose(ours["x"].numpy(), np.asarray(theirs["x"]), atol=ATOL)


def test_mask_is_ignored_at_inference(pairs):
    """train=False returns the mask but runs every token (reference
    maskdit.py:479-483)."""
    _, _, model = pairs["decoder_mae"]
    x, sigma, y = (torch.from_numpy(a) for a in inputs(seed=12))
    info = MaskInfo(*(torch.from_numpy(a) for a in mask_arrays(seed=13)))
    with torch.no_grad():
        masked = model(x, sigma, y, mask_ratio=0.5, mask_info=info, train=False)
        plain = model(x, sigma, y)
    torch.testing.assert_close(masked["x"], plain["x"], rtol=0, atol=0)
    torch.testing.assert_close(masked["mask"], info.mask)


def test_mask_drawn_from_generator(pairs):
    _, _, model = pairs["decoder_mae"]
    x, sigma, y = (torch.from_numpy(a) for a in inputs(seed=14))
    with torch.no_grad():
        a = model(x, sigma, y, mask_ratio=0.5, train=True,
                  generator=torch.Generator().manual_seed(3))
        b = model(x, sigma, y, mask_ratio=0.5, train=True,
                  generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a["x"], b["x"], rtol=0, atol=0)
    assert a["mask"].shape == (N, L) and int(a["mask"].sum()) == N * (L - len_keep_for(L, 0.5))


def test_gradient_reaches_mask_token_and_attention(pairs):
    _, _, model = pairs["decoder_mae"]
    x, sigma, y = (torch.from_numpy(a) for a in inputs(seed=15))
    info = MaskInfo(*(torch.from_numpy(a) for a in mask_arrays(seed=16)))
    model.zero_grad()
    model(x, sigma, y, mask_ratio=0.5, mask_info=info, train=True)["x"].square().sum().backward()
    assert model.model.mask_token.grad.abs().sum() > 0
    assert model.model.blocks[0].attn.qkv.weight.grad.abs().sum() > 0
    model.zero_grad()
