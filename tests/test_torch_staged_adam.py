"""The staged Adam + EMA update (``train.fused_adam: false``) against the
JAX package's staged optimizer.

The JAX side is its own ``make_optimizer(fused=False)`` (``optax.adam``,
``optax.adamw`` with weight decay, ``adam_sr_nu`` with a bf16 nu) and
``_apply_updates_fused``'s staged branch (``optimizer.update``,
``optax.apply_updates``, ``optax.incremental_update``, the ``ema_every``
``lax.cond``), on flat leaves and through one train step of the tiny model
from injected draws. The port's side is ``make_optimizer(fused=False)``
(``ops/fused_adam.StagedAdamEma``) over the flat buffers. Also: the bf16 nu
statistically against ``adam_sr_nu`` (threefry's bits cannot be matched),
the staged step against the fused plain step, resume, the carried JAX
state and the rejections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.train.schedules import lr_with_rampup as jax_lr_with_rampup
from maskdit_tpu.train.state import _apply_updates_fused
from maskdit_tpu.train.state import make_optimizer as jax_make_optimizer
from maskdit_tpu_torch.ops import fused_adam
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step
from maskdit_tpu_torch.train.trainer import Trainer
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax, state_dict_from_flax
from tests import test_torch_train_options as train_options_tests
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_train_options import _jax_step, _port_draws
from tests.test_torch_train_step import DECAY, LR, MAE, RATIO, start, step_inputs  # noqa: F401
from tests.test_torch_trainer import SMOKE, _record_draws

SHAPES = {"kernel": (64, 384), "bias": (384,), "tiny": (3, 5), "ragged": (130,)}
# fp32 on both sides in optax's operation order per element; XLA:CPU may
# contract a product and a sum into one FMA where the port does not: one
# update within TOL, three within TOL3
TOL = dict(rtol=2e-6, atol=1e-7)
TOL3 = dict(rtol=1e-5, atol=1e-7)
N = 8


def _leaves(seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    return {n: dict(p=mk(s), m=mk(s) * 1e-3, v=np.abs(mk(s)) * 1e-5, e=mk(s))
            for n, s in SHAPES.items()}


def _grads(seed):
    return {n: (np.random.default_rng(seed).normal(size=s) * 1e-2).astype(np.float32)
            for n, s in SHAPES.items()}


def _flat(tree) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [np.asarray(tree[n], np.float32).reshape(-1) for n in SHAPES]).copy())


def assert_close(got: torch.Tensor, want: torch.Tensor, tol: dict, what: str) -> None:
    """fp32 values within ``tol``; a bf16 moment within ``tol`` but for the
    rare element where an FMA contraction on one side flips its rounding,
    which then lies one bf16 ulp (at most 2^-7 of the value) away."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float().numpy(), want.float().numpy()
    if not bf16:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
    elif not np.allclose(got, want, **tol):
        off = ~np.isclose(got, want, **tol)
        assert off.mean() < 1e-3, (what, off.mean())
        assert (np.abs(got - want)[off] <= np.abs(want)[off] * 2.0 ** -7).all(), what


CASES = {
    "adam": dict(),
    "mu-bf16": dict(moment_dtype="bfloat16"),
    "g-bf16": dict(g_dtype="bfloat16"),
    "g-mu-bf16": dict(g_dtype="bfloat16", moment_dtype="bfloat16"),
    "adamw": dict(weight_decay=0.01),
    "rampup": dict(rampup_kimg=0.01),
}


@pytest.mark.parametrize("case", list(CASES))
def test_staged_update_matches_optax(case):
    """Three steps with ema_every 2 (the EMA moves at the second step only):
    params, EMA, mu and nu after the first step within TOL of JAX's staged
    update and after the third within TOL3, from the same state and
    gradients; with bf16 gradients optax forms (1 - b1) * g and g**2 in
    bf16, and so does the port."""
    kw = dict(CASES[case])
    g_dtype = kw.pop("g_dtype", "float32")
    rampup = kw.pop("rampup_kimg", 0.0)
    jax_opt = jax_make_optimizer(LR, 4, rampup_kimg=rampup, fused=False, **kw)
    ours = make_optimizer(LR, 4, rampup_kimg=rampup, fused=False, **kw)
    assert isinstance(ours, fused_adam.StagedAdamEma)
    leaves = _leaves(1)
    tree = lambda k: {n: jnp.asarray(v[k]) for n, v in leaves.items()}
    params, ema = tree("p"), tree("e")
    mu_dt = jnp.bfloat16 if kw.get("moment_dtype") else jnp.float32
    state = jax_opt.init(params)
    state = (state[0]._replace(count=jnp.asarray(3, jnp.int32),
                               mu=jax.tree.map(lambda a: a.astype(mu_dt), tree("m")),
                               nu=tree("v")),
             *(s._replace(count=jnp.asarray(3, jnp.int32)) if "count" in s._fields else s
               for s in state[1:]))
    t_params, t_ema = _flat(params), _flat(ema)
    t_state = ours.init(t_params)
    t_state.count = 3
    t_state.mu.copy_(_flat(tree("m")))
    t_state.nu.copy_(_flat(tree("v")))
    assert t_state.mu.dtype == getattr(torch, str(jnp.dtype(mu_dt)))
    for step in range(3):
        g = {n: jnp.asarray(a).astype(getattr(jnp, g_dtype)) for n, a in _grads(10 + step).items()}
        params, state, ema = _jitted_apply_updates(jax_opt, params, g, state, ema, DECAY,
                                                   jnp.asarray(step), ema_every=2)
        t_g = _flat({n: np.asarray(a, np.float32) for n, a in g.items()}).to(
            getattr(torch, g_dtype))
        before = t_ema.clone()
        with_ema = (step + 1) % 2 == 0
        ours.update_with_ema(t_g, t_state, t_params, t_ema, ema_decay=DECAY ** 2 if with_ema
                             else 1.0, with_ema=with_ema)
        assert torch.equal(t_ema, before) != with_ema
        tol = TOL if step == 0 else TOL3
        if step in (0, 2):
            for what, got, want in (("p", t_params, params), ("ema", t_ema, ema),
                                    ("mu", t_state.mu, state[0].mu),
                                    ("nu", t_state.nu, state[0].nu)):
                assert_close(got, _flat({n: np.asarray(a.astype(jnp.float32))
                                         for n, a in want.items()}), tol, f"{case} {what} {step}")
    assert t_state.count == int(state[0].count) == 6


_JITTED = {}


def _jitted_apply_updates(optimizer, params, grads, opt_state, ema, ema_decay, step,
                          ema_every=1):
    """``_apply_updates_fused`` under ``jax.jit``, as the JAX trainer's step
    runs it (XLA may then fuse a product into a sum, where the eager ops
    round each product to its dtype); the EMA decay stays a Python float,
    as the trainer's closure keeps it. One compile per optimizer and
    setting."""
    key = (id(optimizer), ema_decay, ema_every)
    if key not in _JITTED:
        _JITTED[key] = (optimizer, jax.jit(lambda p, g, s, e, t: _apply_updates_fused(
            optimizer, p, g, s, e, ema_decay, t, ema_every=ema_every)))
    return _JITTED[key][1](params, grads, opt_state, ema, step)


def _pair(start, **opt_kw):
    """The JAX staged optimizer and its state from ``start`` (Adam four steps
    in), and the port's state loaded from it through
    ``optimizer_state_from_flax``."""
    jax_model, params, ema, adam, model = start
    optimizer = jax_make_optimizer(LR, N, fused=False, **opt_kw)
    mu_dt = jnp.bfloat16 if opt_kw.get("moment_dtype") else jnp.float32
    adam = adam._replace(mu=jax.tree.map(lambda a: jnp.asarray(a).astype(mu_dt), adam.mu))
    opt_state = (adam, *optimizer.init(params)[1:])
    ours = make_optimizer(LR, N, fused=False, **opt_kw)
    state = create_train_state(model, ours)
    state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                "opt": optimizer_state_from_flax(adam)})
    assert state.opt_state.count == 4 and state.opt_state.mu.dtype == getattr(
        torch, str(jnp.dtype(mu_dt)))
    return optimizer, opt_state, state, ours


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"], ids=["mu-fp32", "mu-bf16"])
def test_staged_train_step_matches_jax(start, moment_dtype, monkeypatch):
    """``make_train_step`` with the staged optimizer against the JAX step
    (its loss and gradient, then ``_apply_updates_fused``'s staged branch)
    on the same params, state and draws, ema_every 2, from the JAX staged
    ``ScaleByAdamState`` carried across by ``optimizer_state_from_flax``:
    one step within TOL, three within TOL3 (the gradients' sums in other
    orders, ~5e-7 relative)."""
    jax_model, params, ema, adam, model = start
    monkeypatch.setattr(train_options_tests, "_apply_updates_fused", _jitted_apply_updates)
    optimizer, opt_state, state, ours = _pair(start, moment_dtype=moment_dtype)
    train_step = make_train_step(ours, mask_ratio=RATIO, mae_loss_coef=MAE,
                                 class_dropout_prob=0.1, ema_decay=DECAY, ema_every=2)
    for step in range(3):
        inputs = step_inputs(120 + step, N)
        params, opt_state, ema, loss, _, draws = _jax_step(
            jax_model, optimizer, params, opt_state, ema, inputs, jax.random.PRNGKey(130 + step),
            step, ema_every=2)
        metrics = train_step(state, {"x": torch.from_numpy(inputs[0]),
                                     "y": torch.from_numpy(inputs[1])},
                             draws=_port_draws(inputs, draws))
        np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-6)
        if step in (0, 2):
            for what, flat, tree in (("p", state.params, params), ("ema", state.ema, ema),
                                     ("mu", state.opt_state.mu, opt_state[0].mu),
                                     ("nu", state.opt_state.nu, opt_state[0].nu)):
                got, want = state.named(flat), state_dict_from_flax(
                    jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.float32), tree))
                for k, v in want.items():
                    assert_close(got[k], v, TOL if step == 0 else TOL3, f"{what}.{k} {step}")
    assert state.opt_state.count == int(opt_state[0].count) == 7


def test_sr_nu_tracks_fp32_as_adam_sr_nu_does():
    """Over 20 steps the staged bf16-nu run stays within the JAX test's
    bounds of the fp32 run (tests/test_fused_adam.py:209-262: nu median
    relative difference < 0.02, max < 0.15; params median < 0.05 lr, max <
    lr), in the port and in the JAX package's ``adam_sr_nu`` alike; nu is
    stored in bf16 and the EMA in fp32."""
    lr = 1e-3
    rng = np.random.default_rng(0)
    params0 = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: np.random.default_rng(300 + k).normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()} for k in range(20)]
    runs = {}
    for nu in (None, "bfloat16"):
        opt = make_optimizer(lr, 4, fused=False, nu_dtype=nu)
        p = _flat(params0)
        e, state = p.clone(), opt.init(p)
        assert state.nu.dtype == (torch.bfloat16 if nu else torch.float32)
        for g in grads:
            opt.update_with_ema(_flat(g), state, p, e, ema_decay=0.995)
        assert e.dtype == torch.float32
        runs[("port", nu)] = (p, state.nu.float())
        jopt = jax_make_optimizer(lr, 4, fused=False, nu_dtype=nu)
        jp = {n: jnp.asarray(a) for n, a in params0.items()}
        je, jstate = jp, jopt.init(jp)
        for k, g in enumerate(grads):
            jp, jstate, je = _jitted_apply_updates(
                jopt, jp, {n: jnp.asarray(a) for n, a in g.items()}, jstate, je, 0.995,
                jnp.asarray(k))
        runs[("jax", nu)] = (_flat({n: np.asarray(a) for n, a in jp.items()}),
                             _flat({n: np.asarray(a, np.float32) for n, a in jstate[0].nu.items()}))
    for side in ("port", "jax"):
        (p32, nu32), (p16, nu16) = runs[(side, None)], runs[(side, "bfloat16")]
        a, b = nu32.double(), nu16.double()
        rel = (a - b).abs() / a.abs().clamp_min(1e-12)
        assert rel.median() < 0.02 and rel.max() < 0.15, (side, rel.median(), rel.max())
        dev = (p32 - p16).abs()
        assert dev.median() < 0.05 * lr and dev.max() < 1.0 * lr, (side, dev.median(), dev.max())
    np.testing.assert_allclose(runs[("port", None)][0].numpy(), runs[("jax", None)][0].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_sr_nu_draws_the_fused_kernels_bits():
    """Given the same count and element index, the staged bf16 nu rounds
    with the bits of kernel #7's plain version: with g = 0 both store
    SR(b2 * v) from the same v, and they store the same bf16 values."""
    n = 4099
    v0 = torch.rand(n, generator=torch.Generator().manual_seed(3)) * 1e-3 + 1e-3
    outs = []
    for opt in (make_optimizer(1e-4, 4, nu_dtype="bfloat16"),
                make_optimizer(1e-4, 4, fused=False, nu_dtype="bfloat16")):
        p = torch.zeros(n)
        state = opt.init(p)
        state.count = 11
        state.nu.copy_(v0)
        opt.update_with_ema(torch.zeros(n), state, p, p.clone())
        outs.append(state.nu.view(torch.int16).clone())
    assert torch.equal(*outs)
    want = fused_adam.stochastic_round_bf16(torch.tensor(np.float32(0.999)) * v0.bfloat16().float(),
                                            11)
    assert torch.equal(outs[0], want.view(torch.int16))


def test_staged_step_against_the_fused_plain_step(start, monkeypatch):
    """One train step of the tiny model from one state and draws, staged
    against the fused update's plain version: the same loss and gradient,
    p / EMA / mu / nu within fp32 rounding (the two round the update in
    other orders); the staged step never reaches kernel #7's wrapper."""
    jax_model, params, ema, adam, model = start
    calls = []
    wrapper = fused_adam.fused_adam_ema

    def counting(*args, **kwargs):
        calls.append(1)
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(fused_adam, "fused_adam_ema", counting)
    inputs = step_inputs(140, N)
    _, _, _, _, _, draws = _jax_step(jax_model, jax_make_optimizer(LR, N, fused=False), params,
                                     (adam, *jax_make_optimizer(LR, N).init(params)[1:]), ema,
                                     inputs, jax.random.PRNGKey(141), 0)
    results = {}
    for fused in (True, False):
        ours = make_optimizer(LR, N, fused=fused)
        state = create_train_state(model, ours)
        state.load({"model": state_dict_from_flax(params), "ema": state_dict_from_flax(ema),
                    "opt": optimizer_state_from_flax(adam)})
        step = make_train_step(ours, mask_ratio=RATIO, mae_loss_coef=MAE, ema_decay=DECAY)
        calls.clear()
        metrics = step(state, {"x": torch.from_numpy(inputs[0]), "y": torch.from_numpy(inputs[1])},
                       draws=_port_draws(inputs, draws))
        assert len(calls) == (1 if fused else 0)
        results[fused] = (float(metrics["loss"]), state.grads.clone(),
                          [t.clone() for t in (state.params, state.ema, state.opt_state.mu,
                                               state.opt_state.nu)])
    assert results[True][0] == results[False][0]
    assert torch.equal(results[True][1], results[False][1])
    for got, want in zip(results[False][2], results[True][2]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_staged_resume_is_bit_for_bit(tmp_path, monkeypatch):
    """With train.fused_adam false (and a bf16 mu), a run of 3 steps resumed
    for 3 more ends as a straight run of 6 ends, bit for bit: the staged
    optimizer keeps the fused one's state and checkpoint."""
    patch_tiny_port(monkeypatch)
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [
        "data.length=4", "train.batchsize=4", "train.fused_adam=false",
        "train.moment_dtype=bfloat16", "log.log_every=1", "log.ckpt_every=100"])

    def trainer(results, steps):
        t = Trainer(cfg, results_dir=str(results), device="cpu", num_workers=1,
                    max_steps_override=steps)
        assert isinstance(t.optimizer, fused_adam.StagedAdamEma)
        t.loader.shuffle = False  # one batch per epoch: the loader restarts on resume
        _record_draws(t, [])
        return t

    straight = trainer(tmp_path / "straight", 6)
    assert straight.train() == 6
    assert trainer(tmp_path / "resumed", 3).train() == 3
    resumed = trainer(tmp_path / "resumed", 3)
    assert resumed.start_step == 3 and resumed.train() == 6
    for a, b in ((straight.state.params, resumed.state.params),
                 (straight.state.ema, resumed.state.ema),
                 (straight.state.opt_state.mu, resumed.state.opt_state.mu),
                 (straight.state.opt_state.nu, resumed.state.opt_state.nu)):
        assert torch.equal(a, b)
    assert straight.state.opt_state.count == resumed.state.opt_state.count == 6


@pytest.mark.parametrize("kw", [
    dict(fused=True, weight_decay=0.01),
    dict(fused=False, nu_dtype="bfloat16", weight_decay=0.01),
    dict(fused=True, nu_dtype="bfloat16", weight_decay=0.01),
    dict(fused=True, nu_dtype="float32"),
    dict(fused=False, nu_dtype="float32"),
], ids=["fused-wd", "staged-nu-wd", "fused-nu-wd", "fused-nu-fp32", "staged-nu-fp32"])
def test_rejections_match_jax(kw):
    """Each combination the JAX ``make_optimizer`` rejects raises the same
    exception with the same message in the port."""
    with pytest.raises((NotImplementedError, ValueError)) as jax_err:
        jax_make_optimizer(1e-4, 8, **kw)
    with pytest.raises(jax_err.type) as port_err:
        make_optimizer(1e-4, 8, **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_staged_accepts_what_jax_accepts():
    """Weight decay with the staged update is ``optax.adamw``'s (the trainer
    never sets it): accepted as in JAX; the rampup schedule's learning rate
    is read at the pre-increment count, as the fused path reads it."""
    opt = make_optimizer(1e-3, 4, fused=False, weight_decay=0.05, rampup_kimg=0.01)
    jax_make_optimizer(1e-3, 4, fused=False, weight_decay=0.05, rampup_kimg=0.01)
    assert opt.weight_decay == 0.05
    assert opt.lr_at(1) == pytest.approx(float(jax_lr_with_rampup(1, 1e-3, 4, 0.01)))
