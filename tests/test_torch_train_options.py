"""The train-step options against the JAX package's, from one state.

``amp_grads`` (differentiate against a bf16 copy of the fp32 parameters,
maskdit_tpu/train/state.py:354-357), ``accum_dtype`` (the accumulator's
dtype, :390-443), ``ema_every`` (:170-224) and a bf16 ``nu_dtype``, at the
tiny dims in fp32 on the CPU with injected draws. The JAX side composes
its own pieces as tests/test_torch_train_step.py does: its loss with the
injected mask, ``jax.value_and_grad`` per micro-batch against the cast
parameters, the accumulator's ``s + g_i.astype(s.dtype)`` and ``/
grad_accum``, and ``_apply_updates_fused``. Also: the options through the
trainer, and a resumed run that ends as a straight run does, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.train.state import _apply_updates_fused
from maskdit_tpu.train.state import make_optimizer as jax_make_optimizer
from maskdit_tpu_torch.models.masking import MaskInfo
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step
from maskdit_tpu_torch.train.trainer import Trainer
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax, state_dict_from_flax
from tests.test_torch_loss import jax_draws
from tests.test_torch_masked_model import CIN, RES
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_train_step import DECAY, LR, MAE, RATIO, start, step_inputs  # noqa: F401
from tests.test_torch_trainer import SMOKE, _record_draws

N = 8


def _jax_step(jax_model, optimizer, params, opt_state, ema, inputs, rng, step, *,
              grad_accum=1, amp=False, accum_dtype=None, ema_every=1):
    """One JAX step from injected draws: returns the new state, the loss,
    the gradient the update read and each micro-batch's draws."""
    moments, labels, z_noise, drop_u, masks = inputs
    mean, logvar = np.split(moments, 2, axis=1)
    x = 0.18215 * (mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0)) * z_noise)
    y = labels * (drop_u >= 0.1).astype(np.float32)
    net_params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params) if amp else params
    micro = x.shape[0] // grad_accum

    loss_and_grad = _jax_loss_and_grad(jax_model)
    acc_dt = jnp.dtype(accum_dtype) if accum_dtype else jnp.float32
    grads, loss_sum, draws = None, 0.0, []
    for i in range(grad_accum):
        rows = slice(i * micro, (i + 1) * micro)
        micro_rng = jax.random.fold_in(rng, i)
        draws.append(jax_draws(micro_rng, (micro, CIN, RES, RES)))
        info = tuple(jnp.asarray(a[rows]) for a in masks)
        loss, g = loss_and_grad(net_params, x[rows], jnp.asarray(y[rows]), info, micro_rng)
        loss_sum += float(loss)
        if grad_accum == 1:
            grads = g
        else:
            grads = (jax.tree.map(lambda p: jnp.zeros(p.shape, acc_dt), params)
                     if grads is None else grads)
            grads = jax.tree.map(lambda s, gi: s + gi.astype(s.dtype), grads, g)
    if grad_accum > 1:
        grads = jax.tree.map(lambda g: g / grad_accum, grads)
    new_params, new_opt, new_ema = _apply_updates_fused(
        optimizer, params, grads, opt_state, ema, DECAY, jnp.asarray(step), ema_every=ema_every)
    return new_params, new_opt, new_ema, loss_sum / grad_accum, grads, draws


_GRAD_FNS = {}


def _jax_loss_and_grad(jax_model):
    """The jitted loss and gradient of one micro-batch with an injected
    mask (one compile per shape and parameter dtype)."""
    if id(jax_model) not in _GRAD_FNS:
        def loss_fn(p, x, y, info, micro_rng):
            def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
                return jax_model.apply({"params": p}, xin, sigma, lab, mask_ratio=m_ratio,
                                       mask_info=JaxMaskInfo(*info), train=True)

            loss_vec, _ = JaxEDMLoss()(net_apply, x, micro_rng, labels=y, mask_ratio=RATIO,
                                       mae_loss_coef=MAE, patch_size=2)
            return loss_vec.mean()

        _GRAD_FNS[id(jax_model)] = jax.jit(jax.value_and_grad(loss_fn))
    return _GRAD_FNS[id(jax_model)]


def _port_draws(inputs, draws):
    _, _, z_noise, drop_u, masks = inputs
    from maskdit_tpu_torch.train.state import StepDraws

    return StepDraws(
        z_noise=torch.from_numpy(z_noise), drop_u=torch.from_numpy(drop_u),
        sigma=torch.from_numpy(np.concatenate([s for s, _ in draws])),
        noise=torch.from_numpy(np.concatenate([n for _, n in draws])),
        mask_info=MaskInfo(*(torch.from_numpy(a) for a in masks)),
    )


def _pair_state(start_state, **step_kw):
    """The JAX optimizer state and the port's state from ``start``, and the
    port's step with ``step_kw``."""
    jax_model, params, ema, adam, model = start_state
    optimizer = jax_make_optimizer(LR, N, fused=True)
    opt_state = (adam, *optimizer.init(params)[1:])
    ours = make_optimizer(LR, N)
    state = create_train_state(model, ours)
    state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                "opt": optimizer_state_from_flax(adam)})
    train_step = make_train_step(ours, mask_ratio=RATIO, mae_loss_coef=MAE,
                                 class_dropout_prob=0.1, ema_decay=DECAY, **step_kw)
    return optimizer, opt_state, state, train_step


def _assert_state(state, params, opt_state, ema, tol):
    for flat, tree in ((state.params, params), (state.ema, ema),
                       (state.opt_state.mu, opt_state[0].mu),
                       (state.opt_state.nu, opt_state[0].nu)):
        got, want = state.named(flat), state_dict_from_flax(tree)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].float().numpy(), v.numpy(), **tol, err_msg=k)


def _restore_fp32_params(state):
    """Give the module back its fp32 parameter views (amp_grads bound them
    to the bf16 copy), so the module-scoped model serves the next test."""
    state.bind(torch.float32, torch.float32)


def test_amp_grads_step_matches_jax(start):
    """The gradient is bf16 (rounded once at the cast's backward) and equals
    JAX's but for the rare element whose fp32 value lies at a bf16 rounding
    boundary; parameters, moments and EMA after the update match to fp32
    ulps (scaled by the learning rate); the master parameters stay fp32."""
    jax_model, params, ema, adam, model = start
    optimizer, opt_state, state, train_step = _pair_state(start, amp_grads=True)
    inputs = step_inputs(70, N)
    rng = jax.random.PRNGKey(71)
    try:
        new_params, new_opt, new_ema, loss, grads, draws = _jax_step(
            jax_model, optimizer, params, opt_state, ema, inputs, rng, 0, amp=True)
        metrics = train_step(state, {"x": torch.from_numpy(inputs[0]),
                                     "y": torch.from_numpy(inputs[1])},
                             draws=_port_draws(inputs, draws))
        assert state.grads.dtype == torch.bfloat16 and state.params.dtype == torch.float32
        assert next(model.parameters()).dtype == torch.bfloat16
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-6)
        got, want = state.named(state.grads), state_dict_from_flax(grads)
        # gradients that are zero but for rounding (the key bias's) differ
        # at the noise floor
        floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
        n_tot = n_off = 0
        for k, v in want.items():
            diff = (got[k].float() - v).abs()
            off = diff > floor
            n_tot, n_off = n_tot + v.numel(), n_off + int(off.sum())
            # a differing element is one bf16 ulp away
            assert (diff[off] <= v.abs()[off] * 2.0 ** -7 * 1.01).all(), k
        assert n_off / n_tot < 1e-3, (n_off, n_tot)
        _assert_state(state, new_params, new_opt, new_ema, dict(rtol=1e-5, atol=2e-7))
    finally:
        _restore_fp32_params(state)


@pytest.mark.parametrize("grad_accum,accum_dtype,amp", [
    (2, "bfloat16", False), (4, "bfloat16", False), (2, None, True), (2, "bfloat16", True),
], ids=["ga2-bf16", "ga4-bf16", "ga2-amp-fp32acc", "ga2-amp-bf16acc"])
def test_accumulator_dtype_matches_jax(start, grad_accum, accum_dtype, amp):
    """The accumulator's dtype: each micro-batch's gradient (fp32, or bf16
    under amp_grads) added as ``s + g_i.astype(s.dtype)``, the sum divided
    in that dtype. Held to JAX's bounds for the bf16 accumulator against
    fp32 (tests/test_train.py:322-380: < 0.5% of the update elements more
    than 0.05 lr apart, median difference < 0.01 lr), port against JAX and
    port against its own fp32 accumulation."""
    jax_model, params, ema, adam, model = start
    inputs = step_inputs(80 + grad_accum, N)
    rng = jax.random.PRNGKey(81)
    batch = {"x": torch.from_numpy(inputs[0]), "y": torch.from_numpy(inputs[1])}
    p0 = state_dict_from_flax(params)
    updates = {}
    try:
        for name, dt in (("port", accum_dtype), ("port-fp32", None)):
            optimizer, opt_state, state, train_step = _pair_state(
                start, grad_accum=grad_accum, accum_dtype=dt, amp_grads=amp)
            new_params, new_opt, new_ema, loss, grads, draws = _jax_step(
                jax_model, optimizer, params, opt_state, ema, inputs, rng, 0,
                grad_accum=grad_accum, amp=amp, accum_dtype=dt)
            metrics = train_step(state, batch, draws=_port_draws(inputs, draws))
            assert state.grads.dtype == (torch.bfloat16 if dt else torch.float32)
            assert (state.micro_grads is not None) == ((torch.bfloat16 if amp else torch.float32)
                                                       != state.grads.dtype)
            np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-6)
            updates[name] = {k: v - p0[k] for k, v in state.named(state.params).items()}
            updates[name.replace("port", "jax")] = {
                k: v - p0[k] for k, v in state_dict_from_flax(new_params).items()}
            _restore_fp32_params(state)
    finally:
        _restore_fp32_params(state)
    for a, b in (("port", "jax"), ("port", "port-fp32"), ("jax", "jax-fp32"),
                 ("port-fp32", "jax-fp32")):
        n_tot = n_off = 0
        medians = []
        for k in p0:
            diff = (updates[a][k] - updates[b][k]).abs()
            n_tot, n_off = n_tot + diff.numel(), n_off + int((diff > 0.05 * LR).sum())
            medians.append(float(diff.median()))
        assert n_off / n_tot < 0.005, (a, b, n_off, n_tot)
        assert np.median(medians) < 0.01 * LR, (a, b)


@pytest.mark.parametrize("ema_every", [2, 4])
def test_ema_every_matches_jax(start, ema_every):
    """Over 8 steps the EMA moves on the steps with (step + 1) % k == 0
    only, with decay**k (formed in double, rounded to fp32), and stays put
    bit for bit on the others; at the end it equals JAX's to fp32
    rounding."""
    jax_model, params, ema, adam, model = start
    optimizer, opt_state, state, train_step = _pair_state(start, ema_every=ema_every)
    for step in range(8):
        inputs = step_inputs(100 + step, 4)
        rng = jax.random.PRNGKey(110 + step)
        params, opt_state, ema, loss, _, draws = _jax_step(
            jax_model, optimizer, params, opt_state, ema, inputs, rng, step,
            ema_every=ema_every)
        before = state.ema.clone()
        train_step(state, {"x": torch.from_numpy(inputs[0]), "y": torch.from_numpy(inputs[1])},
                   draws=_port_draws(inputs, draws))
        moved = not torch.equal(state.ema, before)
        assert moved == ((step + 1) % ema_every == 0), step
    _assert_state(state, params, opt_state, ema, dict(rtol=1e-5, atol=1e-7))


@pytest.mark.parametrize("override", [
    "train.amp_grads=true", "train.ema_every=2", "train.accum_dtype=bfloat16",
    "train.nu_dtype=bfloat16", "train.moment_dtype=bfloat16",
])
def test_ported_train_options_build_a_trainer(tmp_path, monkeypatch, override):
    """The train keys that raised before the options were ported now build a
    Trainer that takes them to its step (the keys that still raise:
    tests/test_torch_trainer.py::test_unported_options_raise)."""
    patch_tiny_port(monkeypatch)
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [override, "train.grad_accum=2"])
    trainer = Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1,
                      max_steps_override=1)
    state = trainer.state
    ema0 = state.ema.clone()
    assert trainer.train() == 1
    took = {
        "train.amp_grads": lambda: state.net_params.dtype == torch.bfloat16,
        # step 0 of each 2: the EMA has not moved
        "train.ema_every": lambda: torch.equal(state.ema, ema0),
        "train.accum_dtype": lambda: state.grads.dtype == torch.bfloat16,
        "train.nu_dtype": lambda: state.opt_state.nu.dtype == torch.bfloat16,
        "train.moment_dtype": lambda: state.opt_state.mu.dtype == torch.bfloat16,
    }[override.split("=")[0]]
    assert took()


def test_resume_with_the_options_is_bit_for_bit(tmp_path, monkeypatch):
    """With amp_grads, a bf16 accumulator over 2 micro-batches, bf16 mu and
    nu and ema_every 2, a run of 3 steps resumed for 3 more ends as a
    straight run of 6 ends, bit for bit: the checkpoint keeps nu in bf16,
    and its stochastic rounding depends on the Adam count, which resumes."""
    patch_tiny_port(monkeypatch)
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [
        "data.length=8", "train.grad_accum=2", "train.batchsize=4", "train.amp_grads=true",
        "train.accum_dtype=bfloat16", "train.moment_dtype=bfloat16",
        "train.nu_dtype=bfloat16", "train.ema_every=2", "log.log_every=1",
        "log.ckpt_every=100"])

    def trainer(results, steps):
        t = Trainer(cfg, results_dir=str(results), device="cpu", num_workers=1,
                    max_steps_override=steps)
        t.loader.shuffle = False  # the loader restarts at epoch 0 on resume
        _record_draws(t, [])
        return t

    straight = trainer(tmp_path / "straight", 6)
    assert straight.train() == 6
    assert trainer(tmp_path / "resumed", 3).train() == 3
    saved = trainer(tmp_path / "resumed", 3).ckpt_mgr.restore()
    assert all(v.dtype == torch.bfloat16 for v in saved["opt"]["nu"].values())
    resumed = trainer(tmp_path / "resumed", 3)
    assert resumed.state.opt_state.nu.dtype == torch.bfloat16
    assert resumed.start_step == 3 and resumed.train() == 6
    for name in ("params", "ema"):
        assert torch.equal(getattr(straight.state, name), getattr(resumed.state, name)), name
    for name in ("mu", "nu"):
        a, b = (getattr(t.state.opt_state, name) for t in (straight, resumed))
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), name
