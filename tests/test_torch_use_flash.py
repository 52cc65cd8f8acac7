"""The port's ``use_flash`` path against the JAX package's.

``model.use_flash`` reaches every ``Attention`` of both packages through
``create_model`` (and the trainer's config): True runs ops/flash.py's
kernels where ``flash.supports(L)`` holds, False the plain path, None
(auto) the packed kernels where they fit and ``mha``'s own rule elsewhere.

* The route: ``models.layers.attention_route`` against the JAX package's
  choice on a TPU for each value of the flag, at every model shape of
  tests/test_torch_512.py and at the tiny shapes.
* The layer and a tiny model with a decoder at 32 x 32 latents (L 256, 128
  kept tokens at mask 0.5: both in the kernel's window) with
  ``use_flash=True``: the JAX side runs its Pallas kernels in the Pallas
  interpreter (``MASKDIT_PALLAS_INTERPRET=1``), the port its plain versions (a CPU tensor); fp32.
* The trainer: ``default_use_flash`` and ``model.use_flash`` as the JAX
  trainer reads them, through the CLI's overrides too.
* The plain route's gradient in bf16 against ``jax.vjp`` of the JAX plain
  path (``attn_from_qkv`` under ``jax.checkpoint``, layers.py:264-277).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models import dit as jax_dit
from maskdit_tpu.models import layers as jax_layers
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.ops import flash as jax_flash
from maskdit_tpu.ops.attention import mha as jax_mha
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.train.trainer import default_use_flash as jax_default_use_flash
from maskdit_tpu_torch.models import create_model, dit, layers
from maskdit_tpu_torch.models.masking import MaskInfo, len_keep_for
from maskdit_tpu_torch.ops import flash, flash_batched
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.state import (
    StepDraws,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.train.trainer import Trainer, default_use_flash
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_512 import (
    NAMED_DIFFERENCES,
    TINY_DIFFERENCES,
    TINY_SHAPES,
    jax_choice,
    model_shapes,
)
from tests.test_torch_layers import _random_params, _to_torch
from tests.test_torch_loss import jax_draws
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_trainer import SMOKE

# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def jax_choice_with_flag(h: int, l: int, hd: int, use_flash) -> str:
    """The JAX package's attention on a TPU for ``Attention(use_flash=...)``:
    auto is tests/test_torch_512.py's rule; True and False go to ``mha``;
    ``flash_mha`` runs plain attention outside its window (flash.py:145)."""
    if use_flash is None:
        choice = jax_choice(h, l, hd)
    else:
        choice = "flash" if use_flash else "plain"
    return "plain" if choice == "flash" and not jax_flash.supports(l) else choice


@pytest.mark.parametrize("use_flash", [None, True, False], ids=str)
def test_route_matches_the_jax_packages_choice_for_each_flag(use_flash):
    named = NAMED_DIFFERENCES if use_flash is None else {}
    differ = {}
    for key, h, l, hd in model_shapes():
        ours = layers.attention_route(h, l, hd, key[-1], use_flash)
        theirs = jax_choice_with_flag(h, l, hd, use_flash)
        if ours != theirs:
            differ[key] = (ours, theirs)
    assert differ == named
    tiny = TINY_DIFFERENCES if use_flash is None else {}
    for h, l, hd in TINY_SHAPES:
        for backward in (False, True):
            pair = (layers.attention_route(h, l, hd, backward, use_flash),
                    jax_choice_with_flag(h, l, hd, use_flash))
            assert pair == tiny.get((h, l, hd), (pair[1], pair[1])), (h, l, hd, backward)
    # with the flag set, the 512-px shapes all run the flash kernels
    if use_flash:
        assert {layers.attention_route(h, l, hd, key[-1], True)
                for key, h, l, hd in model_shapes() if key[1] == 512} == {"flash"}
    # past the kernel's window (L > 2048) flash falls back to plain
    assert layers.attention_route(16, 2176, 72, True, use_flash) == "plain"


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.fixture
def interpret_mode(monkeypatch):
    """The JAX package's own switch (ops/interpret.py): its Pallas calls run
    in the interpreter. ``force_tpu_interpret_mode`` would not do here: its
    callbacks carry effects that ``jax.checkpoint``, around the JAX layer's
    flash path, refuses under differentiation."""
    monkeypatch.setenv("MASKDIT_PALLAS_INTERPRET", "1")


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the port's plain flash forward and backward, and of the
    JAX package's ``flash_mha``."""
    calls = {"fwd": 0, "bwd": 0, "jax": 0}

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(flash, "flash_fwd_reference", counting(flash.flash_fwd_reference, "fwd"))
    monkeypatch.setattr(flash, "flash_bwd_reference", counting(flash.flash_bwd_reference, "bwd"))
    monkeypatch.setattr(jax_flash, "flash_mha", counting(jax_flash.flash_mha, "jax"))
    return calls


def test_attention_layer_matches_jax_flash_layer(interpret_mode, plain_calls):
    """``Attention(use_flash=True)`` at (2, 128, 96), 3 heads of 32: output
    and parameter gradients of sum(sin(out)) against the JAX layer on its
    Pallas kernels (as tests/test_flash.py:145-170 takes them); fp32, sums
    in other orders. With a gradient the port runs the forward twice (the
    checkpoint's recompute) and the backward once; without, the forward
    once."""
    n, l, d, h = 2, 128, 96, 3
    x = np.random.default_rng(0).normal(size=(n, l, d)).astype(np.float32)
    jm = jax_layers.Attention(d, h, dtype=jnp.float32, use_flash=True)
    params = _random_params(jm, jnp.asarray(x))
    theirs = jm.apply({"params": params}, jnp.asarray(x))
    grads = jax.grad(lambda p: jnp.sum(jnp.sin(jm.apply({"params": p}, jnp.asarray(x)))))(params)
    assert plain_calls["jax"] > 0

    tm = layers.Attention(d, h, use_flash=True)
    tm.load_state_dict(_to_torch(params))
    out = tm(torch.from_numpy(x))
    assert (plain_calls["fwd"], plain_calls["bwd"]) == (1, 0)
    torch.sin(out).sum().backward()
    assert (plain_calls["fwd"], plain_calls["bwd"]) == (2, 1)
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert (plain_calls["fwd"], plain_calls["bwd"]) == (3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(theirs), atol=1e-5)
    # the gradients reach a few hundred: relative to each tensor's largest
    want = _to_torch(grads)
    for name, p in tm.named_parameters():
        bound = 1e-6 * float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-5, atol=bound,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# a tiny model at 32 x 32 latents
# ---------------------------------------------------------------------------

RES, CIN, K = 32, 4, 6
L_FULL = (RES // 2) ** 2
TINY = dict(depth=2, hidden_size=64, patch_size=2, num_heads=2)
MODEL_KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
                use_decoder=True, mae_loss_coef=0.1)
BLOCKS = 2 + 1
# fp32 on both sides; sums over up to 256 keys in other orders
ATOL, LOSS_RTOL, GRAD_REL = 1e-5, 1e-5, 1e-4


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    for module in (jax_dit, dit):
        mp.setitem(module.DIT_CONFIGS, "DiT-S/2", TINY)
        mp.setattr(module, "DECODER_HIDDEN_SIZE", 64)
        mp.setattr(module, "DECODER_DEPTH", 1)
        mp.setattr(module, "DECODER_NUM_HEADS", 2)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=True, **MODEL_KW)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
            mask_ratio=0.5, train=True,
        )
    )["params"]
    rng = np.random.default_rng(256)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32),
                          shapes)
    model = create_model("edm", dtype=torch.float32, use_flash=True, **MODEL_KW)
    model.load_state_dict(state_dict_from_flax(params))
    yield jax_model, params, model
    mp.undo()


def test_model_takes_the_flag_to_every_attention(pair):
    _, _, model = pair
    attns = [m for m in model.modules() if isinstance(m, layers.Attention)]
    assert len(attns) == BLOCKS and all(a.use_flash is True for a in attns)


def test_denoiser_matches_jax_flash_path(pair, interpret_mode, plain_calls):
    jax_model, params, model = pair
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, CIN, RES, RES)).astype(np.float32)
    sigma = np.array([0.6, 2.9], np.float32)
    y = np.eye(K, dtype=np.float32)[[3, 0]]
    theirs = jax_model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sigma),
                             jnp.asarray(y))["x"]
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y))["x"]
    assert plain_calls["jax"] == BLOCKS and (plain_calls["fwd"], plain_calls["bwd"]) == (BLOCKS, 0)
    assert ours.shape == (2, CIN, RES, RES) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def _mask_arrays(seed, n):
    rng = np.random.default_rng(seed)
    shuffle = np.argsort(rng.random((n, L_FULL)), axis=1).astype(np.int32)
    restore = np.argsort(shuffle, axis=1).astype(np.int32)
    keep = len_keep_for(L_FULL, 0.5)
    return (restore >= keep).astype(np.float32), shuffle[:, :keep], restore


def test_train_step_matches_jax_flash_path(pair, interpret_mode, plain_calls):
    """Loss and gradients of one masked step (128 of 256 tokens kept, MAE
    on), from injected mask ids, sigma and noise, as tests/test_torch_512.py
    takes them. Each block's attention runs the flash forward twice and its
    backward once."""
    jax_model, params, model = pair
    n = 2
    rng = np.random.default_rng(7)
    moments = rng.normal(size=(n, 2 * CIN, RES, RES)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[[1, 4]]
    z_noise = rng.normal(size=(n, CIN, RES, RES)).astype(np.float32)
    drop_u = np.array([[0.05], [0.6]], np.float32)  # the first label dropped
    masks = _mask_arrays(8, n)
    key = jax.random.PRNGKey(9)

    mean, logvar = np.split(moments, 2, axis=1)
    x = 0.18215 * (mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0)) * z_noise)
    y = labels * (drop_u >= 0.1).astype(np.float32)
    info = JaxMaskInfo(*(jnp.asarray(a) for a in masks))

    def loss_fn(p):
        def net_apply(xin, sig, lab, m_ratio, feat, rngs, mask_info=None):
            return jax_model.apply({"params": p}, xin, sig, lab, mask_ratio=m_ratio,
                                   mask_info=info, train=True)

        loss_vec, _ = JaxEDMLoss()(net_apply, x, key, labels=jnp.asarray(y), mask_ratio=0.5,
                                   mae_loss_coef=0.1, patch_size=2)
        return loss_vec.mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)

    sigma, noise = jax_draws(key, (n, CIN, RES, RES))
    draws = StepDraws(
        z_noise=torch.from_numpy(z_noise), drop_u=torch.from_numpy(drop_u),
        sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise),
        mask_info=MaskInfo(*(torch.from_numpy(a) for a in masks)),
    )
    opt = make_optimizer(1e-4, n)
    state = create_train_state(model, opt)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, class_dropout_prob=0.1)
    metrics = step(state, {"x": torch.from_numpy(moments), "y": torch.from_numpy(labels)},
                   draws=draws)
    assert (plain_calls["fwd"], plain_calls["bwd"]) == (2 * BLOCKS, BLOCKS)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=LOSS_RTOL)
    got, want = state.named(state.grads), state_dict_from_flax(grads)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        err = float((got[k] - v).norm() / v.norm().clamp_min(1e-30))
        assert err <= GRAD_REL, (k, err)
    assert float(got["model.blocks.0.attn.qkv.weight"].norm()) > 0


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_accum,seq_len", [(1, 256), (24, 256), (32, 1024), (1, 1024),
                                                (2, 128), (2, 512)])
def test_default_use_flash_is_the_jax_trainers(grad_accum, seq_len):
    """The cases of tests/test_train.py:473-483 and the L 512 edge."""
    assert default_use_flash(grad_accum, seq_len) is jax_default_use_flash(grad_accum, seq_len)


@pytest.fixture
def tiny_port(monkeypatch):
    patch_tiny_port(monkeypatch)


@pytest.mark.parametrize("overrides,expected", [
    (["model.use_flash=true"], True),
    (["model.use_flash=false"], False),
    (["model.use_flash=null"], None),
    ([], None),
    # accumulating over short sequences: plain unless the config says
    (["train.grad_accum=2"], False),
    (["train.grad_accum=2", "model.use_flash=null"], None),
    (["train.grad_accum=2", "model.use_flash=true"], True),
], ids=lambda v: ",".join(v) if isinstance(v, list) else str(v))
def test_config_flag_reaches_every_attention(tiny_port, tmp_path, overrides, expected):
    """``model.use_flash`` (true, false, null or absent) reaches every
    encoder and decoder ``Attention`` of the trainer's model with the JAX
    trainer's meaning (trainer.py:162-165): an explicit null is auto."""
    cfg = cli.apply_overrides(cli.load_config(SMOKE), overrides)
    trainer = Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1)
    attns = [m for m in trainer.model.modules() if isinstance(m, layers.Attention)]
    assert len(attns) == 2 + 2
    assert [a.use_flash for a in attns] == [expected] * len(attns)


@pytest.mark.parametrize("res", [16, 32])
def test_cli_override_trains_on_the_flash_path(tiny_port, tmp_path, monkeypatch, plain_calls,
                                               res):
    """``model.use_flash=true`` on the CLI (parsed to True) routes every
    attention call of a step away from the packed kernels, to ``mha``. At
    the smoke config's 16 x 16 latents (L 64, 32 kept) that is the plain
    attention, as the JAX ``flash_mha`` falls back outside its window; at
    32 x 32 (L 256, 128 kept) the flash Function: 2 forwards and 1 backward
    per block."""
    assert [cli.parse_value(v) for v in ("true", "false", "null")] == [True, False, None]
    flags = []
    real = layers.mha
    monkeypatch.setattr(layers, "mha",
                        lambda *a, use_flash: flags.append(use_flash) or real(*a, use_flash=use_flash))
    out = cli.main(["--config", SMOKE, "--device", "cpu", "--num_workers", "1",
                    "--results_dir", str(tmp_path), "--max_steps", "1", "model.use_flash=true",
                    f"model.in_size={res}", f"data.resolution={res}"])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert flags and set(flags) == {res == 32}
    blocks = 2 + 2
    expect = (2 * blocks, blocks) if res == 32 else (0, 0)
    assert (plain_calls["fwd"], plain_calls["bwd"]) == expect


# ---------------------------------------------------------------------------
# the plain route in bf16
# ---------------------------------------------------------------------------


class _Given(nn.Module):
    """Stands in for the qkv Linear: returns the given tensor."""

    def __init__(self, value: torch.Tensor):
        super().__init__()
        self.value = value

    def forward(self, x):
        return self.value


def test_plain_route_gradient_is_the_jax_plain_paths_in_bf16():
    """One attention layer on the 'plain' route (``use_flash=False``) at
    (N, L, H, hd) = (2, 128, 4, 32) in bf16: its output and its gradient of
    qkv against ``jax.vjp`` of the JAX plain path, with the same qkv and
    cotangent. Autograd through the plain math rounds where JAX's autodiff
    does (the probabilities' cotangent), so a few elements differ by one
    bf16 ulp (0.02% measured; bound 0.5%); the packed backward's plain
    version, which rounds p and ds, differs in about a third of them."""
    n, l, h, hd = 2, 128, 4, 32
    d = h * hd
    rng = np.random.default_rng(17)
    qkv = rng.normal(size=(n, l, 3 * d)).astype(np.float32)
    g = rng.normal(size=(n, l, d)).astype(np.float32)

    def plain_path(t):  # maskdit_tpu/models/layers.py:264-270, use_flash=False
        r = t.reshape(n, l, 3, h, hd).transpose(2, 0, 3, 1, 4)
        o = jax_mha(r[0], r[1], r[2], use_flash=False)
        return o.transpose(0, 2, 1, 3).reshape(n, l, d)

    theirs, vjp = jax.vjp(jax.checkpoint(plain_path), jnp.asarray(qkv, jnp.bfloat16))
    (dtheirs,) = vjp(jnp.asarray(g, jnp.bfloat16))
    theirs, dtheirs = (np.asarray(a.astype(jnp.float32)) for a in (theirs, dtheirs))

    attn = layers.Attention(d, h, dtype=torch.bfloat16, use_flash=False)
    assert layers.attention_route(h, l, hd, True, False) == "plain"
    leaf = torch.from_numpy(qkv).bfloat16().requires_grad_()
    attn.qkv, attn.proj = _Given(leaf), nn.Identity()
    out = attn(torch.zeros(n, l, d))
    out.backward(torch.from_numpy(g).bfloat16())

    def share_and_err(got, want):
        diff = np.abs(got.float().numpy() - want)
        return (diff > 0).mean(), diff.max() / np.abs(want).max()

    assert out.dtype == leaf.grad.dtype == torch.bfloat16
    for got, want in ((out.detach(), theirs), (leaf.grad, dtheirs)):
        share, err = share_and_err(got, want)
        assert share <= 0.005 and err <= 1e-2, (share, err)
    packed = flash_batched.packed_attention_bwd_reference(
        leaf.detach(), torch.from_numpy(g).bfloat16(), h, hd ** -0.5)
    assert share_and_err(packed, dtheirs)[0] > 0.2
