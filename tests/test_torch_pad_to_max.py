"""Pad-to-max masking in the port against the JAX package, fp32 on the CPU.

``train.pad_to_max`` runs one train step for every mask ratio: the encoder
keeps a fixed ``len_max`` tokens, of which the ratio's first ``len_keep``
are valid; attention masks the padded tail out (``kv_valid``, the plain
path only) and the scatter routes only valid ranks back. Held here:
``padded_random_mask``, ``scatter_tokens_padded`` and
``mha_reference(kv_valid)`` against the JAX functions on the same inputs;
the padded forward, loss and gradients against the JAX model's; the padded
train step against the packed one at the same ratio and draws; the route;
and the trainer's padded run.

Bounds: the masking metadata and the scatter are exact; attention within
1e-6 relative (sums in another order); the loss, the loss terms and the
gradients of the padded forward, and the train steps, within the fp32
parity bounds of chip_smoke.TRAIN_PARITY_BOUND (loss 1e-5 relative, per-tensor
gradient relative norm 1e-4, parameters, EMA and moments 1e-5).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import masking as jax_masking
from maskdit_tpu.ops.attention import mha_reference as jax_mha_reference
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.train.schedules import get_mask_ratio_fn as jax_mask_ratio_fn
from maskdit_tpu.train.trainer import Trainer as JaxTrainer
from maskdit_tpu_torch.models import create_model, masking
from maskdit_tpu_torch.models.layers import Attention, attention_route
from maskdit_tpu_torch.ops.attention import mha, mha_reference
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.state import (
    StepDraws,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.train.trainer import Trainer
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_loss import jax_draws
from tests.test_torch_masked_model import CIN, K, L, RES, make_pair
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_trainer import SMOKE

LOSS_REL, GRAD_REL, STATE_REL = 1e-5, 1e-4, 1e-5
ATTN_REL = 1e-6


@pytest.fixture(scope="module")
def pair(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    yield make_pair(True, 0.1, seed=70)
    mp.undo()


def shuffle_arrays(seed, n, length=L):
    """A per-row shuffle (argsort of uniforms) and its inverse."""
    noise = np.random.default_rng(seed).random((n, length)).astype(np.float32)
    shuffle = np.argsort(noise, axis=1)
    return noise, shuffle, np.argsort(shuffle, axis=1)


def padded_info(shuffle, restore, len_max, len_keep):
    return masking.MaskInfo(
        torch.from_numpy((restore >= len_keep).astype(np.float32)),
        torch.from_numpy(shuffle[:, :len_max]), torch.from_numpy(restore),
        torch.tensor(len_keep))


def packed_info(shuffle, restore, len_keep):
    return masking.MaskInfo(torch.from_numpy((restore >= len_keep).astype(np.float32)),
                            torch.from_numpy(shuffle[:, :len_keep]), torch.from_numpy(restore))


@pytest.mark.parametrize("len_max,len_keep", [(12, 8), (16, 16), (16, 3)])
def test_padded_random_mask_matches_jax(monkeypatch, len_max, len_keep):
    """The same uniforms through both functions give the same mask, kept
    ids, restore map and count; and, as the JAX package's
    test_padded_mask_matches_packed_metadata holds there, the packed mask of
    the same draw is its prefix."""
    n = 3
    noise, _, _ = shuffle_arrays(1, n)
    monkeypatch.setattr(jax.random, "uniform", lambda rng, shape: jnp.asarray(noise))
    want = jax_masking.padded_random_mask(jax.random.PRNGKey(0), n, L, len_max,
                                          jnp.asarray(len_keep))
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    real_rand = torch.rand
    monkeypatch.setattr(torch, "rand", lambda *a, **kw: torch.from_numpy(noise))
    got = masking.padded_random_mask(n, L, len_max, torch.tensor(len_keep), gen)
    monkeypatch.undo()
    assert torch.rand is real_rand
    for name in ("mask", "ids_keep", "ids_restore", "len_keep"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.ids_keep.shape == (n, len_max) and got.len_keep.dtype == torch.int64
    # one generator draw, the packed function's: same shuffle, prefix of ids
    gen.set_state(state)
    padded = masking.padded_random_mask(n, L, len_max, torch.tensor(len_keep), gen)
    gen.set_state(state)
    packed = masking.random_mask(n, L, 1 - len_keep / L, gen)
    assert torch.equal(padded.mask, packed.mask)
    assert torch.equal(padded.ids_restore, packed.ids_restore)
    assert torch.equal(padded.ids_keep[:, :len_keep], packed.ids_keep)


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.3, 0.5, 0.7])
def test_padded_len_keep_is_the_jax_losss(ratio):
    """floor(L * (1 - ratio)) in fp32, as the JAX loss forms it from a
    traced ratio (loss.py:107-110)."""
    for length in (16, 64, 256, 1024):
        want = jnp.floor(length * (1.0 - jnp.asarray(ratio, jnp.float32))).astype(jnp.int32)
        assert int(masking.padded_len_keep(length, ratio)) == int(want)


@pytest.mark.parametrize("len_keep", [1, 5, 12])
def test_scatter_tokens_padded_matches_jax(len_keep):
    """Same tokens (a NaN-poisoned padded tail), restore map, token and count:
    equal outputs, and no NaN reaches them."""
    n, len_max, d = 2, 12, 5
    _, shuffle, restore = shuffle_arrays(2, n)
    x = np.random.default_rng(3).normal(size=(n, len_max, d)).astype(np.float32)
    x[:, len_keep:] = np.nan
    token = np.random.default_rng(4).normal(size=(1, 1, d)).astype(np.float32)
    want = jax_masking.scatter_tokens_padded(jnp.asarray(x), jnp.asarray(restore),
                                             jnp.asarray(token), jnp.asarray(len_keep))
    got = masking.scatter_tokens_padded(torch.from_numpy(x), torch.from_numpy(restore),
                                        torch.from_numpy(token), torch.tensor(len_keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("kv_valid", [1, 7, 16])
def test_mha_reference_kv_valid_matches_jax(kv_valid):
    """Keys at positions >= kv_valid take no part (16: all valid); the rows
    of every query, valid or not, as the JAX function computes them."""
    rng = np.random.default_rng(kv_valid)
    q, k, v = (rng.normal(size=(2, 3, 16, 8)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_mha_reference(*map(jnp.asarray, (q, k, v)),
                                        kv_valid=jnp.asarray(kv_valid)))
    t = lambda a: torch.from_numpy(a)
    got = mha_reference(t(q), t(k), t(v), kv_valid=torch.tensor(kv_valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_REL, atol=ATTN_REL)
    # mha sends kv_valid to the plain math whatever use_flash says
    for use_flash in (None, True, False):
        torch.testing.assert_close(mha(t(q), t(k), t(v), use_flash=use_flash,
                                       kv_valid=torch.tensor(kv_valid)), got, rtol=0, atol=0)
    # the tail's values do not reach the valid rows
    k2, v2 = k.copy(), v.copy()
    k2[:, :, kv_valid:], v2[:, :, kv_valid:] = 1e3, -1e3
    again = mha_reference(t(q), t(k2), t(v2), kv_valid=torch.tensor(kv_valid))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_route_is_plain_with_kv_valid():
    """A layer given kv_valid runs the plain attention under the checkpoint
    (JAX layers.py:225-277), whatever use_flash and the shape say."""
    for use_flash in (None, True, False):
        for l, hd in ((128, 72), (256, 72), (512, 72), (1024, 32), (2048, 72)):
            assert attention_route(16, l, hd, True, use_flash, True) == "plain"
    assert attention_route(16, 128, 72, True, None) == "packed"
    torch.manual_seed(0)
    attn = Attention(32, 4)
    x = torch.randn(2, 10, 32, requires_grad=True)
    full = attn(x)
    out = attn(x, torch.tensor(6))
    assert not torch.allclose(out[:, :6], full[:, :6])
    # the valid rows do not depend on the tail's tokens
    x2 = x.detach().clone()
    x2[:, 6:] = 5.0
    torch.testing.assert_close(attn(x2, torch.tensor(6))[:, :6], out[:, :6], rtol=0, atol=0)
    out[:, :6].square().sum().backward()
    assert x.grad[:, :6].abs().sum() > 0 and float(x.grad[:, 6:].abs().sum()) == 0.0


@pytest.mark.parametrize("len_max,ratio", [(14, 0.5), (16, 0.25), (16, 0.0)])
def test_padded_forward_loss_and_gradients_match_jax(pair, len_max, ratio):
    """The JAX EDMLoss with mask_len_max draws its padded mask from its rng;
    the port gets that mask, sigma and the noise injected. Loss, output and
    gradients agree."""
    jax_model, params, model = pair
    rng_np = np.random.default_rng(71)
    n = 3
    images = rng_np.normal(size=(n, CIN, RES, RES)).astype(np.float32) * 0.5
    labels = np.eye(K, dtype=np.float32)[[2, 5, 1]]
    rng = jax.random.PRNGKey(72)
    len_keep = jnp.floor(L * (1.0 - jnp.asarray(ratio, jnp.float32))).astype(jnp.int32)
    jinfo = jax_masking.padded_random_mask(jax.random.split(rng, 3)[2], n, L, len_max, len_keep)

    def jax_loss(p):
        def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
            return jax_model.apply({"params": p}, xin, sigma, lab, mask_ratio=m_ratio,
                                   mask_info=mask_info, train=True, rngs=rngs)

        vec, aux = JaxEDMLoss()(net_apply, jnp.asarray(images), rng, labels=jnp.asarray(labels),
                                mask_ratio=jnp.asarray(ratio, jnp.float32), mae_loss_coef=0.1,
                                patch_size=2, mask_len_max=len_max)
        return vec.mean(), aux

    (want_loss, want_aux), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    sigma, noise = jax_draws(rng, images.shape)
    info = masking.MaskInfo(*(torch.from_numpy(np.array(a)) for a in jinfo[:3]),
                            torch.tensor(int(len_keep)))
    model.zero_grad()
    vec, aux = EDMLoss()(model, torch.from_numpy(images), torch.from_numpy(labels),
                         mask_ratio=ratio, mae_loss_coef=0.1, sigma=torch.from_numpy(sigma),
                         noise=torch.from_numpy(noise), mask_info=info, mask_len_max=len_max)
    vec.mean().backward()
    np.testing.assert_allclose(float(vec.mean().detach()), float(want_loss), rtol=LOSS_REL)
    for k in ("dsm_loss", "mae_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=LOSS_REL, atol=1e-7)
    want = state_dict_from_flax(want_grads)
    for name, p in model.named_parameters():
        ref = want[name]
        err = float((p.grad - ref).norm() / ref.norm().clamp_min(1e-30))
        assert err <= GRAD_REL, (name, err)


def draws_for(seed, n, ratio, len_max):
    """The same draws for a packed and a pad-to-max step at ``ratio``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    base = dict(z_noise=t(rng.normal(size=(n, CIN, RES, RES))), drop_u=t(rng.random((n, 1))),
                sigma=t(np.exp(rng.normal(size=n) * 1.2 - 1.2)),
                noise=t(rng.normal(size=(n, CIN, RES, RES))))
    _, shuffle, restore = shuffle_arrays(seed + 1, n)
    len_keep = int(masking.padded_len_keep(L, ratio))
    packed = packed_info(shuffle, restore, len_keep) if ratio > 0 else None
    return (StepDraws(**base, mask_info=packed),
            StepDraws(**base, mask_info=padded_info(shuffle, restore, len_max, len_keep)))


def rel_norm(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("ratio,len_max", [(0.5, 14), (0.25, 14), (0.0, 16)])
def test_padded_step_equals_the_packed_step(pair, ratio, len_max):
    """One pad-to-max train step (len_max at least the ratio's kept count,
    as the schedule's maximum is) against the packed step at the same
    ratio, from one state with the same draws: loss, gradients, parameters,
    EMA and moments within the fp32 parity bounds."""
    _, params, _ = pair
    n = 4
    rng = np.random.default_rng(80)
    moments = torch.from_numpy(rng.normal(size=(n, 2 * CIN, RES, RES)).astype(np.float32))
    labels = torch.from_numpy(np.eye(K, dtype=np.float32)[rng.integers(0, K, n)])
    packed_draws, padded_draws = draws_for(81, n, ratio, len_max)
    results = []
    for padded in (False, True):
        model = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=K,
                             model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1,
                             dtype=torch.float32)
        model.load_state_dict(state_dict_from_flax(params))
        opt = make_optimizer(1e-3, n)
        state = create_train_state(model, opt)
        if padded:
            step = make_train_step(opt, mae_loss_coef=0.1, pad_to_max=True, mask_len_max=len_max)
            batch = {"x": moments, "y": labels, "mask_ratio": ratio}
            metrics = step(state, batch, draws=padded_draws)
        else:
            step = make_train_step(opt, mask_ratio=ratio, mae_loss_coef=0.1)
            metrics = step(state, {"x": moments, "y": labels}, draws=packed_draws)
        tensors = {f"grad.{k}": v.clone() for k, v in state.named(state.grads).items()}
        for name, flat in (("p", state.params), ("ema", state.ema), ("mu", state.opt_state.mu),
                           ("nu", state.opt_state.nu)):
            tensors.update({f"{name}.{k}": v.clone() for k, v in state.named(flat).items()})
        results.append((float(metrics["loss"]), tensors))
    (loss, want), (got_loss, got) = results
    assert abs(got_loss - loss) <= LOSS_REL * abs(loss)
    for k, ref in want.items():
        bound = GRAD_REL if k.startswith("grad.") else STATE_REL
        if ref.norm() > 0:
            assert rel_norm(got[k], ref) <= bound, k
    assert want["grad.model.blocks.0.attn.qkv.weight"].norm() > 0


def test_trainer_trains_pad_to_max(tmp_path, monkeypatch):
    """``train.pad_to_max: true`` (no longer refused) on a cosine schedule:
    one step for every ratio, the encoder at the JAX trainer's
    ``_mask_len_max`` tokens every step, finite losses, and each step's
    ratio riding the batch as the JAX trainer sends it."""
    patch_tiny_port(monkeypatch)
    overrides = ["train.pad_to_max=true", "model.mask_ratio_fn=cosine2",
                 "model.mask_ratio_min=0.1", "log.log_every=1", "log.ckpt_every=100"]
    cfg = cli.apply_overrides(cli.load_config(SMOKE), overrides)
    trainer = Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1,
                      max_steps_override=4)
    widths, ratios = [], []
    trainer.model.model.decoder_layer.register_forward_pre_hook(
        lambda mod, args: widths.append(args[0].shape[1]))
    real = trainer._step_for_ratio

    def step_for_ratio(ratio):
        step = real(ratio)
        return lambda state, batch, gen: ratios.append(batch["mask_ratio"]) or step(state, batch,
                                                                                    gen)

    trainer._step_for_ratio = step_for_ratio
    assert trainer.train() == 4
    assert list(trainer._step_cache) == ["padded"]
    m = cfg["model"]
    fn = jax_mask_ratio_fn(m["mask_ratio_fn"], m["mask_ratio"], m["mask_ratio_min"])
    seq_len = (m["in_size"] // 2) ** 2
    len_max = JaxTrainer._mask_len_max(types.SimpleNamespace(mask_ratio_fn=fn, seq_len=seq_len))
    assert trainer._mask_len_max() == len_max and widths == [len_max] * 4
    assert ratios == pytest.approx([float(fn(s / 4)) for s in range(4)], rel=1e-12)
    assert [r["mask_ratio"] for r in trainer.history] == ratios
    assert np.isfinite([x for r in trainer.history for x in r["losses"]]).all()
