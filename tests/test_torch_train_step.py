"""Three training steps of the port against the JAX package's, from one state.

The JAX side composes its own pieces: the moments -> z reparameterisation
and label dropout with injected draws, ``EDMLoss`` with a ``net_apply``
that passes an injected ``MaskInfo``, ``jax.value_and_grad``, and the
fused Adam + EMA update of ``FusedAdamEma``. The port runs its
``make_train_step`` with ``StepDraws`` carrying the same draws (sigma and
noise recomputed from the JAX loss's rng split). The starting state (params,
EMA, Adam count, mu and nu) is carried across with ``state_dict_from_flax``
and ``optimizer_state_from_flax``. fp32 on the CPU, tiny dims.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.train.state import make_optimizer as jax_make_optimizer
from maskdit_tpu_torch.models.masking import MaskInfo
from maskdit_tpu_torch.train.state import (
    StepDraws,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax, state_dict_from_flax
from tests.test_torch_loss import jax_draws
from tests.test_torch_masked_model import CIN, K, RES, make_pair, mask_arrays
from tests.test_torch_model import patch_tiny_port

LR, DECAY, RATIO, MAE = 1e-3, 0.99, 0.5, 0.1
N = 4
# fp32, sums in other orders: per-leaf gradients agree to ~5e-7 relative
# and the losses to ~2e-7; the grad norm of one flat fp32 buffer (torch)
# against optax's per-leaf sums differs by up to ~7e-6. After three updates
# params, EMA and moments differ by < 2e-8 absolute.
LOSS_RTOL, NORM_RTOL = 1e-6, 2e-5
STATE_TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def start(tiny_dit_module):
    """A tiny model and a non-trivial state: random params, an EMA off the
    params, Adam four steps in with random moments."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_model, params, model = make_pair(True, MAE, seed=40)
    rng = np.random.default_rng(41)
    near = lambda tree, s: jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, s, x.shape)).astype(np.float32), tree
    )
    ema = near(params, 0.01)
    adam = optax.adam(LR).init(params)[0]._replace(
        count=jnp.asarray(4, jnp.int32),
        mu=jax.tree.map(lambda x: rng.normal(0, 1e-3, x.shape).astype(np.float32), params),
        nu=jax.tree.map(lambda x: np.abs(rng.normal(0, 1e-5, x.shape)).astype(np.float32), params),
    )
    yield jax_model, params, ema, adam, model
    mp.undo()


def step_inputs(seed, n=N):
    """A batch of moments and labels, and every draw of one step."""
    rng = np.random.default_rng(seed)
    moments = rng.normal(size=(n, 2 * CIN, RES, RES)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    z_noise = rng.normal(size=(n, CIN, RES, RES)).astype(np.float32)
    drop_u = rng.random((n, 1)).astype(np.float32)
    drop_u[0] = 0.05  # one label dropped for sure
    return moments, labels, z_noise, drop_u, mask_arrays(seed + 1, RATIO, n)


def jax_step(jax_model, optimizer, params, opt_state, ema, inputs, rng):
    moments, labels, z_noise, drop_u, masks = inputs
    mean, logvar = np.split(moments, 2, axis=1)
    x = 0.18215 * (mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0)) * z_noise)
    y = labels * (drop_u >= 0.1).astype(np.float32)
    info = JaxMaskInfo(*(jnp.asarray(a) for a in masks))

    def loss_fn(p):
        def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
            return jax_model.apply({"params": p}, xin, sigma, lab, mask_ratio=m_ratio,
                                   mask_info=info, train=True)

        loss_vec, _ = JaxEDMLoss()(net_apply, x, rng, labels=jnp.asarray(y),
                                   mask_ratio=RATIO, mae_loss_coef=MAE, patch_size=2)
        return loss_vec.mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params, new_opt, new_ema = optimizer.update_with_ema(
        grads, opt_state, params, ema, ema_decay=DECAY
    )
    return new_params, new_opt, new_ema, float(loss), float(optax.global_norm(grads))


def port_draws(inputs, rng):
    moments, _, z_noise, drop_u, masks = inputs
    sigma, noise = jax_draws(rng, (moments.shape[0], CIN, RES, RES))
    return StepDraws(
        z_noise=torch.from_numpy(z_noise), drop_u=torch.from_numpy(drop_u),
        sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise),
        mask_info=MaskInfo(*(torch.from_numpy(a) for a in masks)),
    )


def test_three_steps_match_jax(start):
    jax_model, params, ema, adam, model = start
    optimizer = jax_make_optimizer(LR, N, fused=True)
    opt_state = (adam, *optimizer.init(params)[1:])

    ours = make_optimizer(LR, N)
    state = create_train_state(model, ours)
    state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                "opt": optimizer_state_from_flax(adam)})
    train_step = make_train_step(ours, mask_ratio=RATIO, mae_loss_coef=MAE,
                                 class_dropout_prob=0.1, ema_decay=DECAY)
    for step in range(3):
        inputs = step_inputs(50 + 10 * step)
        rng = jax.random.PRNGKey(60 + step)
        params, opt_state, ema, loss, gnorm = jax_step(
            jax_model, optimizer, params, opt_state, ema, inputs, rng
        )
        metrics = train_step(state, {"x": torch.from_numpy(inputs[0]),
                                     "y": torch.from_numpy(inputs[1])},
                             draws=port_draws(inputs, rng))
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["grad_norm"]), gnorm, rtol=NORM_RTOL)
    assert state.step == 3 and state.opt_state.count == int(opt_state[0].count) == 7
    for flat, tree in ((state.params, params), (state.ema, ema),
                       (state.opt_state.mu, opt_state[0].mu),
                       (state.opt_state.nu, opt_state[0].nu)):
        got, want = state.named(flat), state_dict_from_flax(tree)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **STATE_TOL, err_msg=k)
    # the parameters moved, and the model's parameters are the flat buffer
    moved = state.named(state.params)["model.blocks.0.attn.qkv.weight"]
    assert not np.allclose(moved.numpy(), state_dict_from_flax(start[1])[
        "model.blocks.0.attn.qkv.weight"].numpy(), atol=1e-6)
    assert model.model.blocks[0].attn.qkv.weight.data_ptr() == moved.data_ptr()


def test_grad_accum_matches_one_batch(start):
    """grad_accum=2 over micro-batches of 2 gives the step of one batch of 4:
    the mean of the two micro-batch means is the batch mean."""
    _, params, ema, adam, model = start
    inputs = step_inputs(90)
    draws = port_draws(inputs, jax.random.PRNGKey(91))
    batch = {"x": torch.from_numpy(inputs[0]), "y": torch.from_numpy(inputs[1])}
    results = []
    for accum in (1, 2):
        opt = make_optimizer(LR, N)
        state = create_train_state(model, opt)
        state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                    "opt": optimizer_state_from_flax(adam)})
        step = make_train_step(opt, mask_ratio=RATIO, mae_loss_coef=MAE, ema_decay=DECAY,
                               grad_accum=accum)
        metrics = step(state, batch, draws=draws)
        results.append((metrics, state.grads.clone(), state.params.clone(), state.ema.clone()))
    (m1, g1, p1, e1), (m2, g2, p2, e2) = results
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    torch.testing.assert_close(g2, g1, rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(p2, p1, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(e2, e1, rtol=1e-5, atol=2e-6)


def test_own_draws_are_seeded(start):
    """Without injected draws the step draws z, dropout, sigma, noise and
    the mask from its generator: the same seed gives the same step."""
    _, params, ema, adam, model = start
    inputs = step_inputs(95)
    batch = {"x": torch.from_numpy(inputs[0]), "y": torch.from_numpy(inputs[1])}
    losses = []
    for seed in (0, 0, 1):
        opt = make_optimizer(LR, N)
        state = create_train_state(model, opt)
        state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                    "opt": optimizer_state_from_flax(adam)})
        step = make_train_step(opt, mask_ratio=RATIO, mae_loss_coef=MAE)
        losses.append(float(step(state, batch, torch.Generator().manual_seed(seed))["loss"]))
    assert losses[0] == losses[1] != losses[2]
    assert all(np.isfinite(losses))
