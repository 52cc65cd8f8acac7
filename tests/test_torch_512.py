"""The port's 512-px slice against the JAX package's.

* The attention route: ``models.layers.attention_route`` against the JAX
  package's choice on a TPU (``flash_batched.supports``, else
  ``flash_big.supports``, else ``mha``'s own rule, layers.py:237-277 and
  attention.py:83-91) at every shape of DiT-XL/2, L/2, B/2 and S/2 at 256
  and 512 px, masked and unmasked, encoder and decoder, and at the tests'
  tiny shapes, with ``use_flash`` None (auto; tests/test_torch_use_flash.py
  takes the other values). The two rules differ only where
  NAMED_DIFFERENCES says.
* The slice as a whole at the 512-px geometry (64 x 64 latents: L 1024
  unmasked, 512 kept tokens at mask 0.5) and small widths: the encoder has
  XL/2's head dim of 72 (8 heads, width 576, so that neither package's
  whole-row kernel takes L 512), the decoder 4 heads of 16. The JAX model
  runs its Pallas kernels (``flash_big``) in interpret mode, forced onto
  its kernel path as tests/test_flash.py forces it; the port runs on the
  CPU, where the blocked attention takes its plain versions. Weights are
  carried across with ``state_dict_from_flax``. Checked: one CFG denoiser
  evaluation, and one train step's loss and gradients from injected mask
  ids, sigma and noise.
* The 512-px CLIs on the CPU at tiny widths, and chip_smoke.py's 512-px
  configs against the released YAML files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models import dit as jax_dit
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.ops import flash_batched as jax_fb
from maskdit_tpu.ops import flash_big as jax_big
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.utils import config as jax_config
from maskdit_tpu_torch import generate
from maskdit_tpu_torch.models import create_model, dit, layers
from maskdit_tpu_torch.models.masking import MaskInfo, len_keep_for
from maskdit_tpu_torch.ops.flash_batched import packed_attention_plain as flash_batched_plain
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.state import (
    StepDraws,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_loss import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE_512 = os.path.join(ROOT, "configs", "test", "maskdit-512.yaml")
TRAIN_512 = os.path.join(ROOT, "configs", "train", "imagenet512-latent.yaml")

# ---------------------------------------------------------------------------
# the attention route
# ---------------------------------------------------------------------------

MODELS = ("DiT-XL/2", "DiT-L/2", "DiT-B/2", "DiT-S/2")
# (model, px, tokens, block, backward) -> (port, JAX). At 256 px without a
# mask, XL/2's encoder trains at L 256, hd 72: the JAX package runs its
# whole-row kernels there, but the port's whole-row backward needs 236,544 B
# of shared memory per block in its key pass (4 KB over the card's 232,448),
# so the port trains that shape on its blocked kernels, which take any L.
# Sampling (no backward) still takes the whole-row kernel.
# At 512 px S/2's encoder trains at L 512, hd 64: the TPU's budget is per
# sample (all 6 heads, width 384, fit its 12 MB), the card's per head and
# row block (the whole-row backward needs 419,840 B at L 512, hd 64), so
# the port runs its blocked kernels there.
NAMED_DIFFERENCES = {
    ("DiT-XL/2", 256, "unmasked", "encoder", True): ("big", "packed"),
    ("DiT-S/2", 512, "masked", "encoder", True): ("big", "packed"),
}
# the tests' tiny shapes (heads, L, head dim): conftest's tiny DiT-S/2 at
# 8 x 8 latents (L 16, masked 8) and this file's 512-px geometry. At L 16
# and 8 the port runs its whole-row kernels (they mask the padding to 32
# rows); the TPU's need a lane-aligned L, so the JAX package runs its plain
# attention there.
TINY_SHAPES = [(4, 16, 16), (4, 8, 16), (8, 1024, 72), (8, 512, 72), (4, 1024, 16)]
TINY_DIFFERENCES = {(4, 16, 16): ("packed", "plain"), (4, 8, 16): ("packed", "plain")}


def jax_choice(h: int, l: int, hd: int) -> str:
    """The JAX package's attention on a TPU for a packed (N, L, h * hd)."""
    if jax_fb.supports(h, l, hd):
        return "packed"
    if jax_big.supports(h, l, hd):
        return "big"
    if l >= 1024 and l % 128 == 0:  # mha's auto rule: ops/flash.py's kernel
        return "flash"
    return "plain"


def port_choice(h: int, l: int, hd: int, backward: bool) -> str:
    return layers.attention_route(h, l, hd, backward)


def model_shapes():
    """(key, heads, L, head dim) of every attention call of the four model
    sizes at 256 and 512 px."""
    out = []
    for model in MODELS:
        cfg = dit.DIT_CONFIGS[model]
        for px in (256, 512):
            full = (px // 8 // cfg["patch_size"]) ** 2
            for tokens, backwards in (("masked", (True,)), ("unmasked", (False, True))):
                l_enc = len_keep_for(full, 0.5) if tokens == "masked" else full
                for backward in backwards:
                    out.append(((model, px, tokens, "encoder", backward), cfg["num_heads"],
                                l_enc, cfg["hidden_size"] // cfg["num_heads"]))
                    out.append(((model, px, tokens, "decoder", backward), dit.DECODER_NUM_HEADS,
                                full, dit.DECODER_HIDDEN_SIZE // dit.DECODER_NUM_HEADS))
    return out


def test_route_matches_the_jax_packages_choice_at_every_model_shape():
    shapes = model_shapes()
    assert len(shapes) == 4 * 2 * 3 * 2
    differ = {}
    for key, h, l, hd in shapes:
        ours, theirs = port_choice(h, l, hd, key[-1]), jax_choice(h, l, hd)
        if ours != theirs:
            differ[key] = (ours, theirs)
    assert differ == NAMED_DIFFERENCES
    # where the JAX package runs a kernel, so does the port
    assert all(port_choice(h, l, hd, key[-1]) != "plain" for key, h, l, hd in shapes
               if jax_choice(h, l, hd) != "plain")
    # the 512-px paths take the blocked kernels, the 256-px ones the
    # whole-row kernels, as in the JAX package
    xl = {key: port_choice(h, l, hd, key[-1]) for key, h, l, hd in shapes
          if key[0] == "DiT-XL/2"}
    assert {xl[k] for k in xl if k[1] == 512} == {"big"}
    assert {xl[k] for k in xl if k[1] == 256 and k not in NAMED_DIFFERENCES} == {"packed"}


@pytest.mark.parametrize("shape", TINY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_route_at_the_tiny_test_shapes(shape):
    h, l, hd = shape
    for backward in (False, True):
        pair = (port_choice(h, l, hd, backward), jax_choice(h, l, hd))
        assert pair == TINY_DIFFERENCES.get(shape, (pair[1], pair[1])), (shape, backward)


def test_unmasked_256_training_takes_the_blocked_kernels(monkeypatch):
    """XL/2's encoder at L 256, hd 72 (trained unmasked at 256 px): with a
    backward the layer calls the blocked attention, without one the
    whole-row attention; both give the whole-row plain version's output and
    gradient (the same rounding points; fp32 sums in another order)."""
    h, hd = 2, 72
    assert layers.attention_route(16, 256, hd, True) == "big"
    assert layers.attention_route(16, 256, hd, False) == "packed"
    calls = []
    for name in ("packed_attention", "packed_attention_big"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name, lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    monkeypatch.setattr(layers.flash_batched, "fits",
                        lambda l, d, backward: not backward)  # the card's verdict at L 256, hd 72
    layers.attention_route.cache_clear()
    try:
        attn = layers.Attention(h * hd, h)
        x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 256, h * hd))
                             .astype(np.float32)).requires_grad_()
        out = attn(x)
        out.square().sum().backward()
        with torch.no_grad():
            attn(x)
    finally:
        layers.attention_route.cache_clear()
    assert calls == ["packed_attention_big", "packed_attention"]
    ref_x = x.detach().clone().requires_grad_()
    qkv = attn.qkv(ref_x)
    ref = attn.proj(flash_batched_plain(qkv, h, hd ** -0.5))
    ref.square().sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x.grad, ref_x.grad, rtol=1e-5, atol=1e-6)


def test_route_raises_where_the_jax_package_runs_its_streaming_kernel():
    """L 2048 (hd 72) fits neither packed kernel of the port; the JAX
    package's mha runs its streaming kernel (ops/flash.py) there, and so
    does the port (tests/test_torch_use_flash.py holds that route). The
    route still raises where only the whole-row backward does not fit and
    the blocked kernels cannot take the head dim."""
    assert jax_choice(16, 2048, 72) == "flash"
    for backward in (False, True):
        assert layers.attention_route(16, 2048, 72, backward) == "flash"
    assert layers.attention_route(16, 640, 72, False) == "plain" == jax_choice(16, 640, 72)
    # a whole-row shape whose backward does not fit, at a head dim the
    # blocked kernels cannot load: raise, not plain attention
    assert layers.flash_batched.fits(640, 20, False) and not layers.flash_batched.fits(640, 20, True)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        layers.attention_route(1, 640, 20, True)


# ---------------------------------------------------------------------------
# the slice at the 512-px geometry
# ---------------------------------------------------------------------------

RES, CIN, K = 64, 4, 6
L_FULL = (RES // 2) ** 2
TINY_512 = dict(depth=2, hidden_size=576, patch_size=2, num_heads=8)
MODEL_KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
                use_decoder=True, mae_loss_coef=0.1)
# fp32 on both sides; attention sums over up to 1024 keys in other orders:
# outputs agree to ~1e-6, the loss to ~1e-7 relative, gradients to ~1e-6
# of each tensor's norm
ATOL, LOSS_RTOL, GRAD_REL = 3e-5, 1e-5, 1e-4


def patch_512(mp: pytest.MonkeyPatch) -> None:
    """DiT-S/2 shrunk to the widths above in both packages."""
    for module in (jax_dit, dit):
        mp.setitem(module.DIT_CONFIGS, "DiT-S/2", TINY_512)
        mp.setattr(module, "DECODER_HIDDEN_SIZE", 64)
        mp.setattr(module, "DECODER_DEPTH", 2)
        mp.setattr(module, "DECODER_NUM_HEADS", 4)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    patch_512(mp)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=None, **MODEL_KW)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
            mask_ratio=0.5, train=True,
        )
    )["params"]
    rng = np.random.default_rng(512)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.02, size=x.shape).astype(np.float32),
                          shapes)
    model = create_model("edm", dtype=torch.float32, **MODEL_KW)
    model.load_state_dict(state_dict_from_flax(params))
    yield jax_model, params, model
    mp.undo()


@pytest.fixture
def jax_kernel_path(monkeypatch):
    """The JAX layer picks its Pallas kernels only on a TPU backend: claim
    one, run the kernels in interpret mode, and count the blocked calls of
    both packages."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    calls = {"jax": 0, "port": 0}

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_big, "packed_attention_big",
                        counting(jax_big.packed_attention_big, "jax"))
    monkeypatch.setattr(layers, "packed_attention_big",
                        counting(layers.packed_attention_big, "port"))
    with pltpu.force_tpu_interpret_mode():
        yield calls


def test_denoiser_matches_jax_kernel_path(pair, jax_kernel_path):
    jax_model, params, model = pair
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, CIN, RES, RES)).astype(np.float32)
    sigma = np.array([0.7, 3.1], np.float32)
    y = np.eye(K, dtype=np.float32)[[2, 5]]
    theirs = jax_model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sigma),
                             jnp.asarray(y), cfg_scale=1.5)["x"]
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y),
                     cfg_scale=1.5)["x"]
    assert jax_kernel_path["jax"] > 0
    assert jax_kernel_path["port"] == 2 + 2  # every block, encoder and decoder
    assert ours.shape == (2, CIN, RES, RES) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def _mask_arrays(seed, n):
    rng = np.random.default_rng(seed)
    shuffle = np.argsort(rng.random((n, L_FULL)), axis=1).astype(np.int32)
    restore = np.argsort(shuffle, axis=1).astype(np.int32)
    keep = len_keep_for(L_FULL, 0.5)
    return (restore >= keep).astype(np.float32), shuffle[:, :keep], restore


def test_train_step_matches_jax_kernel_path(pair, jax_kernel_path):
    """Loss and gradients of one masked step (512 of 1024 tokens kept, MAE
    on): the JAX side composes EDMLoss with an injected MaskInfo under
    value_and_grad, as tests/test_torch_train_step.py does."""
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
    assert jax_kernel_path["jax"] > 0 and jax_kernel_path["port"] == 2 + 2
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=LOSS_RTOL)
    got, want = state.named(state.grads), state_dict_from_flax(grads)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        err = float((got[k] - v).norm() / v.norm().clamp_min(1e-30))
        assert err <= GRAD_REL, (k, err)
    # the gradient reached the encoder's first attention through every
    # attention backward above it
    assert float(got["model.blocks.0.attn.qkv.weight"].norm()) > 0


# ---------------------------------------------------------------------------
# the 512-px CLIs and chip_smoke.py's configs
# ---------------------------------------------------------------------------

def test_chip_smoke_samples_the_released_512_config():
    released = jax_config.load(SAMPLE_512).to_container()
    assert chip_smoke.SAMPLE_CONFIG_512 == {"model": released["model"]}


def test_chip_smoke_trains_the_released_512_config():
    """chip_smoke.py's JSON config is configs/train/imagenet512-latent.yaml's
    model, train and data sections (WebDataset shards, indexed) but for
    data.root, which is [extract]'s shards, and the cuts it lists in
    TRAIN_CUTS_512."""
    released = jax_config.load(TRAIN_512).to_container()
    smoke = chip_smoke.TRAIN_CONFIG_512
    cuts = chip_smoke.TRAIN_CUTS_512
    for section in ("model", "train"):
        assert set(smoke[section]) == set(released[section]), section
        for key, value in released[section].items():
            if f"{section}.{key}" not in cuts:
                assert smoke[section][key] == value, f"{section}.{key}"
    assert smoke["data"] == {**released["data"], "root": chip_smoke.TRAIN_DATA_ROOT_512}
    assert smoke["data"]["category"] == "webdataset"
    for path, (was, now) in cuts.items():
        section, key = path.split(".")
        assert released[section][key] == was and smoke[section][key] == now, path


@pytest.fixture
def tiny_xl(monkeypatch):
    """DiT-XL/2, which the released configs name, shrunk (XL/2's head dim
    of 72 on 2 heads, 1 block; decoder 1 block of 2 heads of 32) so the
    512-px CLIs run on the CPU; counts the blocked calls."""
    monkeypatch.setitem(dit.DIT_CONFIGS, "DiT-XL/2",
                        dict(depth=1, hidden_size=144, patch_size=2, num_heads=2))
    monkeypatch.setattr(dit, "DECODER_HIDDEN_SIZE", 64)
    monkeypatch.setattr(dit, "DECODER_DEPTH", 1)
    monkeypatch.setattr(dit, "DECODER_NUM_HEADS", 2)
    calls = []
    real = layers.packed_attention_big
    monkeypatch.setattr(layers, "packed_attention_big",
                        lambda qkv, *a: calls.append(tuple(qkv.shape)) or real(qkv, *a))
    return calls


def test_generate_cli_runs_the_512_config_on_the_cpu(tiny_xl, tmp_path):
    model = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1)
    ckpt = tmp_path / "tiny-xl.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    outdir = tmp_path / "out"
    result = generate.main([
        "--ckpt_path", str(ckpt), "--outdir", str(outdir), "--no_decode",
        "--config", SAMPLE_512, "--seeds", "0-1", "--max_batch_size", "2",
        "--cfg_scale", "1.5", "--num_steps", "2", "--device", "cpu",
    ])
    assert result["images"] == 2
    z = np.load(outdir / "latents_000000.npy")
    assert z.shape == (2, CIN, RES, RES) and np.isfinite(z).all()
    # 3 evaluations x (1 encoder + 1 decoder block), CFG batch 4, L 1024
    assert tiny_xl == [(4, L_FULL, 3 * 144), (4, L_FULL, 3 * 64)] * 3


def test_train_cli_runs_the_512_config_on_the_cpu(tiny_xl, tmp_path):
    from maskdit_tpu_torch.data.wds import write_wds_shards

    path = tmp_path / "train-512.json"
    path.write_text(__import__("json").dumps(chip_smoke.TRAIN_CONFIG_512))
    rng = np.random.default_rng(0)
    shards = str(tmp_path / "wds")
    write_wds_shards([(f"{i:07d}", rng.normal(size=(2 * CIN, RES, RES)).astype(np.float32), i)
                      for i in range(4)], shards, maxcount=2)
    out = cli.main(["--config", str(path), "--results_dir", str(tmp_path / "results"),
                    "--device", "cpu", "--num_workers", "1", "--max_steps", "1",
                    "train.batchsize=2", f"data.root={shards}"])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    # the encoder at the 512 kept tokens, the decoder at all 1024
    assert tiny_xl == [(2, 512, 3 * 144), (2, L_FULL, 3 * 64)]
