"""The port's EDM samplers against the JAX package's.

Both samplers run the analytic linear denoiser of tests/test_sampler.py on
the same latents, so only the loops are compared; the bound is that file's
(rtol 1e-4, atol 1e-5). Churn noise cannot match across RNGs, so the churn
test hands the port the very draws the JAX sampler makes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.sampling import edm as jax_edm
from maskdit_tpu_torch.sampling import edm
from maskdit_tpu_torch.utils.rng import StackedRandomGenerator

SIGMA_DATA = 0.5
TOL = dict(rtol=1e-4, atol=1e-5)


def linear_denoiser(x, sigma):
    """Optimal denoiser for x0 ~ N(0, sigma_data^2 I)."""
    return x * SIGMA_DATA ** 2 / (sigma ** 2 + SIGMA_DATA ** 2)


def _latents(seed, shape=(2, 3, 4, 4)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("num_steps", [2, 18, 40])
def test_sigma_steps_equal_jax(num_steps):
    np.testing.assert_array_equal(
        edm.edm_sigma_steps(num_steps), jax_edm.edm_sigma_steps(num_steps)
    )


@pytest.mark.parametrize("num_steps", [4, 40])
def test_edm_sampler_matches_jax(num_steps):
    z = _latents(1)
    ours = edm.edm_sampler(linear_denoiser, torch.from_numpy(z), num_steps=num_steps)
    theirs = jax_edm.edm_sampler(linear_denoiser, jnp.asarray(z), num_steps=num_steps)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_edm_sampler_churn_matches_jax_with_the_same_noise(monkeypatch):
    z = _latents(2)
    num_steps, churn = 8, 30.0
    key = jax.random.PRNGKey(7)
    draws = iter(
        torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, i), z.shape)))
        for i in range(num_steps)
    )
    monkeypatch.setattr(edm, "_churn_noise", lambda x, generator: next(draws))
    kw = dict(num_steps=num_steps, S_churn=churn, S_min=0.05, S_max=50.0)
    ours = edm.edm_sampler(linear_denoiser, torch.from_numpy(z), **kw)
    theirs = jax_edm.edm_sampler(linear_denoiser, jnp.asarray(z), rng=key, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_churn_needs_a_generator_and_follows_it():
    z = torch.from_numpy(_latents(3))
    with pytest.raises(ValueError, match="generator"):
        edm.edm_sampler(linear_denoiser, z, num_steps=4, S_churn=10.0)
    runs = [
        edm.edm_sampler(linear_denoiser, z, torch.Generator().manual_seed(s),
                        num_steps=4, S_churn=10.0)
        for s in (5, 5, 6)
    ]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("solver,disc,sched,scal", [
    ("heun", "edm", "linear", "none"),
    ("euler", "vp", "vp", "vp"),
    ("heun", "vp", "vp", "vp"),
    ("heun", "ve", "ve", "none"),
    ("euler", "iddpm", "linear", "none"),
])
def test_ablation_sampler_matches_jax(solver, disc, sched, scal):
    z = _latents(4)
    kw = dict(num_steps=12, solver=solver, discretization=disc, schedule=sched,
              scaling=scal)
    ours = edm.ablation_sampler(linear_denoiser, torch.from_numpy(z), **kw)
    theirs = jax_edm.ablation_sampler(linear_denoiser, jnp.asarray(z), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_net_sigma_surface_clamps_like_a_direct_request():
    z = torch.from_numpy(_latents(5))
    clamped = edm.edm_sampler(linear_denoiser, z, num_steps=8,
                              net_sigma_min=0.01, net_sigma_max=40.0,
                              round_sigma=lambda s: s)
    direct = edm.edm_sampler(linear_denoiser, z, num_steps=8, sigma_min=0.01, sigma_max=40.0)
    torch.testing.assert_close(clamped, direct, rtol=0, atol=0)


def test_stacked_generator_draws_depend_only_on_the_seed():
    a = StackedRandomGenerator("cpu", [3, 11, 42])
    b = StackedRandomGenerator("cpu", [42, 3])
    za, zb = a.randn([3, 4, 2, 2]), b.randn([2, 4, 2, 2])
    torch.testing.assert_close(za[0], zb[1], rtol=0, atol=0)
    torch.testing.assert_close(za[2], zb[0], rtol=0, atol=0)
    ya, yb = a.randint(1000, size=[3]), b.randint(1000, size=[2])
    assert ya[0] == yb[1] and ya[2] == yb[0]
    assert not torch.equal(za[0], za[1])
    with pytest.raises(ValueError):
        a.randn([2, 4])
