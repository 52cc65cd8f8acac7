"""The port's EDM loss, its pieces and the schedules against the JAX package.

The JAX side is its own ``EDMLoss.__call__`` with a ``net_apply`` that
passes an injected ``MaskInfo``; sigma and the noise are the values JAX
draws from its ``rng`` split (loss.py:101-108), recomputed here and handed
to the port. fp32 on the CPU, tiny dims.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.train import loss as jax_loss
from maskdit_tpu.train import schedules as jax_schedules
from maskdit_tpu_torch.models.masking import MaskInfo
from maskdit_tpu_torch.train import loss, schedules
from tests.test_torch_masked_model import CIN, K, N, RES, make_pair, mask_arrays
from tests.test_torch_model import patch_tiny_port

# losses of order 1 from a tiny fp32 model; the model's own bound is 3e-5
ATOL = 3e-5


def test_patchify_and_per_patch_mean_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 8)).astype(np.float32)
    for p in (2, 4):
        np.testing.assert_array_equal(
            loss.patchify(torch.from_numpy(x), p).numpy(),
            np.asarray(jax_loss.patchify(jnp.asarray(x), p)),
        )
        np.testing.assert_allclose(
            loss.per_patch_mean(torch.from_numpy(x), p).numpy(),
            np.asarray(jax_loss.per_patch_mean(jnp.asarray(x), p)), rtol=1e-6, atol=1e-7,
        )


@pytest.mark.parametrize("norm_pix_loss", [True, False])
def test_mae_loss_matches_jax(norm_pix_loss):
    rng = np.random.default_rng(1)
    target = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    pred = rng.normal(size=(3, 4, 8, 8)).astype(np.float32)
    mask = (rng.random((3, 16)) < 0.5).astype(np.float32)
    mask[2] = 0.0  # no masked patch: the max(count, 1) guard
    ours = loss.mae_loss(torch.from_numpy(target), torch.from_numpy(pred),
                         torch.from_numpy(mask), 2, norm_pix_loss)
    theirs = jax_loss.mae_loss(jnp.asarray(target), jnp.asarray(pred), jnp.asarray(mask), 2,
                               norm_pix_loss)
    assert ours[2] == 0
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    yield make_pair(True, 0.1, seed=30)
    mp.undo()


def jax_draws(rng, shape):
    """sigma (N,) and unit noise as EDMLoss.__call__ draws them from rng."""
    rng_sigma, rng_noise, _ = jax.random.split(rng, 3)
    rnd = jax.random.normal(rng_sigma, (shape[0], 1, 1, 1))
    sigma = jnp.exp(rnd * 1.2 + -1.2)
    return np.array(sigma).reshape(-1), np.array(jax.random.normal(rng_noise, shape))


@pytest.mark.parametrize("mask_ratio,mae_coef", [(0.5, 0.1), (0.5, 0.0), (0.0, 0.0)])
def test_edm_loss_matches_jax(pair, mask_ratio, mae_coef):
    jax_model, params, model = pair
    rng_np = np.random.default_rng(31)
    images = rng_np.normal(size=(N, CIN, RES, RES)).astype(np.float32) * 0.5
    labels = np.eye(K, dtype=np.float32)[[2, 5, 1]]
    arrays = mask_arrays(seed=32)
    jinfo = JaxMaskInfo(*(jnp.asarray(a) for a in arrays))

    def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
        return jax_model.apply({"params": params}, xin, sigma, lab, mask_ratio=m_ratio,
                               mask_info=jinfo if m_ratio > 0 else None, train=True)

    rng = jax.random.PRNGKey(33)
    theirs, taux = jax_loss.EDMLoss()(
        net_apply, jnp.asarray(images), rng, labels=jnp.asarray(labels),
        mask_ratio=mask_ratio, mae_loss_coef=mae_coef, patch_size=2,
    )
    sigma, noise = jax_draws(rng, images.shape)
    with torch.no_grad():
        ours, aux = loss.EDMLoss()(
            model, torch.from_numpy(images), torch.from_numpy(labels), mask_ratio=mask_ratio,
            mae_loss_coef=mae_coef, patch_size=2, sigma=torch.from_numpy(sigma),
            noise=torch.from_numpy(noise),
            mask_info=MaskInfo(*(torch.from_numpy(a) for a in arrays)),
        )
    assert ours.shape == (N,)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=ATOL)
    assert sorted(aux) == sorted(taux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(taux[k]), rtol=1e-5, atol=ATOL, err_msg=k)


def test_edm_loss_draws_from_generator(pair):
    _, _, model = pair
    images = torch.from_numpy(np.random.default_rng(34).normal(size=(N, CIN, RES, RES)).astype(np.float32))
    run = lambda seed: loss.EDMLoss()(model, images, None, mask_ratio=0.5, mae_loss_coef=0.1,
                                      generator=torch.Generator().manual_seed(seed))[0]
    with torch.no_grad():
        a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["constant", "linear", "exp", "cosine2", "cosine4", "cos4"])
def test_mask_ratio_fns_match_jax(name):
    ours = schedules.get_mask_ratio_fn(name, 0.7, 0.1)
    theirs = jax_schedules.get_mask_ratio_fn(name, 0.7, 0.1)
    for x in np.linspace(0.0, 1.0, 11):
        assert ours(float(x)) == pytest.approx(theirs(float(x)), rel=1e-12, abs=1e-12)
    with pytest.raises(ValueError):
        schedules.get_mask_ratio_fn("cosine9")


def test_bucket_ratio_and_lr_rampup_match_jax():
    for ratio in np.linspace(0.0, 0.95, 20):
        for length in (64, 256, 1024):
            assert schedules.bucket_ratio(float(ratio), length) == jax_schedules.bucket_ratio(
                float(ratio), length)
    for step in (0, 1, 5, 39, 40, 1000):
        got = schedules.lr_with_rampup(step, 1e-4, 256, 10.0)
        want = float(jax_schedules.lr_with_rampup(step, 1e-4, 256, 10.0))
        assert got == pytest.approx(want, rel=1e-6)
    assert schedules.lr_with_rampup(10 ** 6, 1e-4, 256, 10.0) == 1e-4
    assert math.isclose(schedules.lr_with_rampup(20, 1e-4, 256, 10.0), 1e-4 * 0.512)
