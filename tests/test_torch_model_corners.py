"""The model corners against the JAX package's, at tiny dims in fp32.

The class token (``pad_cls_token``, with and without the decoder, and with
``direct_cls_token``), external-feature conditioning (``ext_feature_dim``)
and encoder self-conditioning (``use_encoder_feat``): the JAX ``MaskDiT`` /
``EDMPrecond`` (plain attention) and the port's, with the JAX weights carried
across by ``state_dict_from_flax``, on inputs drawn with numpy from a seed.
Checked to within 1e-5 of max|ref|: the forward at mask 0.5 and 0 in
training and at inference, pad-to-max with a class token, ``encode``, the
CFG forward with ``feat``, the masked gradients, and one train step with
``feat`` over two micro-batches against the JAX ``state.make_train_step``
(pad-to-max, whose draws the port is given). Also the feature LMDB:
``retrieve_n_features`` in its three modes, the dataset's join (and its
refusal of records whose labels differ) and the loader's ``feat``; the
reference-``.pt`` import of the new embedders; and ``attention_route`` at
the class-token lengths against the JAX choice.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskdit_tpu.data import datasets as jax_datasets
from maskdit_tpu.data import features as jax_features
from maskdit_tpu.data import loader as jax_loader
from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models import dit as jax_dit
from maskdit_tpu.models import masking as jax_masking
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.models.precond import EDMPrecond as JaxEDMPrecond
from maskdit_tpu.train import state as jax_state
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu_torch.data import datasets, features
from maskdit_tpu_torch.data.loader import DataLoader
from maskdit_tpu_torch.models import create_model, dit, layers, masking
from maskdit_tpu_torch.models.masking import MaskInfo, padded_len_keep
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.state import (
    StepDraws,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.utils.ckpt import load_into, load_reference_checkpoint, load_reference_states
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax, state_dict_from_flax
from tests.test_torch_512 import jax_choice, tiny_xl  # noqa: F401 (a fixture)
from tests.test_torch_loss import jax_draws
from tests.test_torch_masked_model import mask_arrays
from tests.test_torch_model import patch_tiny_port

RES, CIN, K, N, F = 8, 4, 6, 3, 5
L = (RES // 2) ** 2
# fp32 on both sides, sums in other orders: within this share of max|ref|
REL = 1e-5
# the variants: EDMPrecond keywords, or (direct_cls_token, which the JAX
# EDMPrecond does not take) MaskDiT keywords
VARIANTS = {
    "cls_decoder": dict(pad_cls_token=True, use_decoder=True, mae_loss_coef=0.1),
    "cls_no_decoder": dict(pad_cls_token=True, use_decoder=False),
    "cls_direct": dict(pad_cls_token=True, direct_cls_token=True, use_decoder=True,
                       mae_loss_coef=0.1),
    "feat": dict(pad_cls_token=True, use_decoder=True, mae_loss_coef=0.1, ext_feature_dim=F),
    "enc_feat": dict(use_decoder=True, mae_loss_coef=0.1, use_encoder_feat=True),
}
MODES = {"mask0.5": (0.5, True), "mask0": (0.0, True), "inference": (0.0, False)}


def assert_rel(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"
    return err / scale


def _init_all(module, x, t, y, feat):
    """Touch every parameter: a masked training forward (mask token, class
    token embedder, feature embedder), then an inference forward (the
    encoder feature's embedder)."""
    module(x, t, y, feat=feat, mask_ratio=0.5, train=True)
    return module(x, t, y, train=False)


def make_pair(name, seed):
    """(JAX module, its params, the port's module with the same weights,
    whether the pair is MaskDiT rather than EDMPrecond)."""
    kw = VARIANTS[name]
    direct = kw.get("direct_cls_token", False)
    if direct:
        jax_model = jax_dit.create_dit("DiT-S/2", input_size=RES, in_channels=CIN, num_classes=K,
                                       dtype=jnp.float32, use_flash=False, **kw)
        model = dit.create_dit("DiT-S/2", input_size=RES, in_channels=CIN, num_classes=K,
                               dtype=torch.float32, **kw)
    else:
        common = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2")
        jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **common, **kw)
        model = create_model("edm", dtype=torch.float32, **common, **kw)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)), jnp.zeros((1, F)),
        method=_init_all))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: rng.normal(0.0, 0.05, size=s.shape).astype(np.float32),
                          shapes)
    if direct:
        state = {k[len("model."):]: v for k, v in state_dict_from_flax({"model": params}).items()}
    else:
        state = state_dict_from_flax(params)
    model.load_state_dict(state)  # strict: every parameter of both sides
    return jax_model, params, model, direct


@pytest.fixture(scope="module")
def pairs(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    yield {name: make_pair(name, seed=i) for i, name in enumerate(VARIANTS)}
    mp.undo()


def inputs(seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, CIN, RES, RES)).astype(np.float32)
    t = np.exp(rng.normal(size=n) - 0.5).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    feat = rng.normal(size=(n, F)).astype(np.float32)
    return x, t, y, feat


def _feat(name, feat):
    return feat if VARIANTS[name].get("ext_feature_dim") else None


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(pairs, name, mode):
    """The model's output at mask 0.5 (the encoder at 8 kept tokens + the
    class token), at mask 0 in training, and at inference (where
    ``use_encoder_feat`` runs ``encode`` first)."""
    jax_model, params, model, _ = pairs[name]
    ratio, train = MODES[mode]
    x, t, y, feat = inputs(10)
    feat = _feat(name, feat)
    arrays = mask_arrays(11) if ratio else None
    want = jax_model.apply(
        {"params": params}, _j(x), _j(t), _j(y), mask_ratio=ratio, train=train, feat=_j(feat),
        mask_info=JaxMaskInfo(*map(_j, arrays)) if ratio else None)
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(y), mask_ratio=ratio, train=train, feat=_t(feat),
                    mask_info=MaskInfo(*map(_t, arrays)) if ratio else None)
    assert_rel(got["x"].numpy(), want["x"], what=f"{name} {mode}")
    if ratio:
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))


@pytest.mark.parametrize("extras", [1, 2])
def test_scatter_tokens_carry_the_leading_tokens_as_jax(extras):
    """``scatter_tokens`` and ``scatter_tokens_padded`` with ``extras``
    leading tokens (JAX masking.py:103-149): the leading tokens pass the
    scatter unshuffled, the kept ones go back to their positions."""
    rng = np.random.default_rng(40 + extras)
    x = rng.normal(size=(N, extras + 8, 6)).astype(np.float32)
    token = rng.normal(size=(1, 1, 6)).astype(np.float32)
    _, _, restore = mask_arrays(41)
    got = masking.scatter_tokens(_t(x), _t(restore).long(), _t(token), extras=extras)
    want = jax_masking.scatter_tokens(_j(x), _j(restore), _j(token), extras=extras)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (N, extras + L, 6)
    padded = rng.normal(size=(N, extras + 14, 6)).astype(np.float32)
    got = masking.scatter_tokens_padded(_t(padded), _t(restore).long(), _t(token),
                                        torch.tensor(8), extras=extras)
    want = jax_masking.scatter_tokens_padded(_j(padded), _j(restore), _j(token), jnp.asarray(8),
                                             extras=extras)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _padded(seed, len_max, len_keep, n=N):
    rng = np.random.default_rng(seed)
    shuffle = np.argsort(rng.random((n, L)), axis=1)
    restore = np.argsort(shuffle, axis=1)
    mask = (restore >= len_keep).astype(np.float32)
    return mask, shuffle[:, :len_max], restore


@pytest.mark.parametrize("name", ["cls_decoder", "cls_no_decoder"])
def test_padded_forward_with_a_class_token_matches_jax(pairs, name):
    """Pad-to-max (14 of 16 tokens, 8 valid): the encoder runs 1 + 14
    tokens with ``kv_valid`` = 8 + 1, and only the valid ones scatter back
    past the class token."""
    jax_model, params, model, _ = pairs[name]
    x, t, y, _ = inputs(12)
    len_max, len_keep = 14, 8
    arrays = _padded(13, len_max, len_keep)
    want = jax_model.apply({"params": params}, _j(x), _j(t), _j(y), mask_ratio=0.5, train=True,
                           mask_info=JaxMaskInfo(*map(_j, arrays), jnp.asarray(len_keep)))
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(y), mask_ratio=0.5, train=True,
                    mask_info=MaskInfo(*(_t(a).long() for a in arrays), torch.tensor(len_keep)))
    assert_rel(got["x"].numpy(), want["x"], what=name)


@pytest.mark.parametrize("padded", [False, True], ids=["all_tokens", "pad_to_max"])
def test_encode_matches_jax(pairs, padded):
    """``EDMPrecond.encode``: the pooled, normalised encoder feature past the
    class token; under pad-to-max the masked mean over the valid tokens."""
    jax_model, params, model, _ = pairs["cls_decoder"]
    x, t, y, _ = inputs(14)
    kw_j, kw_t = {}, {}
    if padded:
        arrays = _padded(15, 14, 8)
        kw_j = dict(mask_ratio=0.5, mask_info=JaxMaskInfo(*map(_j, arrays), jnp.asarray(8)))
        kw_t = dict(mask_ratio=0.5, mask_info=MaskInfo(*(_t(a).long() for a in arrays),
                                                       torch.tensor(8)))
    want = jax_model.apply({"params": params}, _j(x), _j(t), _j(y), method=JaxEDMPrecond.encode,
                           **kw_j)
    with torch.no_grad():
        got = model.encode(_t(x), _t(t), _t(y), **kw_t)
    assert got.shape == (N, 64)
    assert_rel(got.numpy(), want)


@pytest.mark.parametrize("name", ["feat", "enc_feat"])
def test_cfg_forward_with_feat_matches_jax(pairs, name):
    """``forward_with_cfg(feat=)`` doubles the features for the unconditional
    half; with self-conditioning the encoder feature of the doubled batch
    is computed first."""
    jax_model, params, model, _ = pairs[name]
    x, t, y, feat = inputs(16)
    feat = _feat(name, feat)
    want = jax_model.apply({"params": params}, _j(x), _j(t), _j(y), cfg_scale=1.5, feat=_j(feat))
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(y), cfg_scale=1.5, feat=_t(feat))
    assert_rel(got["x"].numpy(), want["x"], what=name)


@pytest.mark.parametrize("ratio", [0.5, 0.0], ids=["mask0.5", "mask0"])
def test_gradients_with_a_class_token_match_jax(pairs, ratio):
    """The EDM loss and every gradient (class token and its embedder
    included) with injected sigma, noise and mask, at the two class-token
    lengths of training: 8 + 1 and 16 + 1 encoder tokens."""
    jax_model, params, model, _ = pairs["feat"]
    x, _, y, feat = inputs(17)
    arrays = mask_arrays(18) if ratio else None
    jinfo = JaxMaskInfo(*map(_j, arrays)) if ratio else None
    rng = jax.random.PRNGKey(19)

    def jax_loss(p):
        def net_apply(xin, sigma, lab, m_ratio, f, rngs, mask_info=None):
            return jax_model.apply({"params": p}, xin, sigma, lab, mask_ratio=m_ratio,
                                   mask_info=jinfo, feat=f, train=True)

        vec, _ = JaxEDMLoss()(net_apply, _j(x), rng, labels=_j(y), mask_ratio=ratio,
                              mae_loss_coef=0.1, patch_size=2, feat=_j(feat))
        return vec.mean()

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    sigma, noise = jax_draws(rng, x.shape)
    model.zero_grad()
    vec, _ = EDMLoss()(model, _t(x), _t(y), mask_ratio=ratio, mae_loss_coef=0.1,
                       sigma=_t(sigma), noise=_t(noise),
                       mask_info=MaskInfo(*map(_t, arrays)) if ratio else None, feat=_t(feat))
    vec.mean().backward()
    assert_rel(float(vec.mean().detach()), float(want_loss), what="loss")
    want = state_dict_from_flax(want_grads)
    assert {"model.cls_token", "model.cls_token_embedder.weight",
            "model.feat_embedder.weight"} <= set(want)
    for key, p in model.named_parameters():
        # (the mask token has no gradient at mask 0: JAX's is zeros)
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert_rel(grad.numpy(), want[key].numpy(), what=key)
    model.zero_grad()


def test_train_step_with_feat_and_grad_accum_matches_the_jax_state_step(pairs):
    """One step of the JAX ``state.make_train_step`` (pad-to-max, two
    micro-batches of 2, class token, features) against the port's step
    given the JAX step's draws: the moment noise, the label dropout, each
    micro-batch's sigma, noise and padded mask. Loss, gradient norm,
    parameters, EMA and Adam's moments agree."""
    jax_model, params, model, _ = pairs["feat"]
    n, lr, decay, ratio = 4, 1e-3, 0.99, 0.5
    rng_np = np.random.default_rng(20)
    moments = rng_np.normal(size=(n, 2 * CIN, RES, RES)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[rng_np.integers(0, K, n)]
    feat = rng_np.normal(size=(n, F)).astype(np.float32)
    optimizer = jax_state.make_optimizer(lr, n, fused=True)
    # Adam four steps in, with moments of the gradients' scale (a fresh
    # Adam's first update is lr * sign(g), which amplifies the last bits of
    # the near-zero gradients)
    adam = optax.adam(lr).init(params)[0]._replace(
        count=jnp.asarray(4, jnp.int32),
        mu=jax.tree.map(lambda p: rng_np.normal(0, 1e-3, p.shape).astype(np.float32), params),
        nu=jax.tree.map(lambda p: np.abs(rng_np.normal(0, 1e-5, p.shape)).astype(np.float32),
                        params))
    jstate = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  ema_params=jax.tree.map(lambda p: p * 0.9, params),
                                  opt_state=(adam, *optimizer.init(params)[1:]))
    step = jax_state.make_train_step(jax_model, optimizer, mae_loss_coef=0.1, ema_decay=decay,
                                     grad_accum=2, pad_to_max=True)
    key = jax.random.PRNGKey(21)
    batch = {"x": _j(moments), "y": _j(labels), "feat": _j(feat),
             "mask_ratio": jnp.asarray(ratio, jnp.float32)}
    new, metrics = step(jstate, batch, key)

    # the JAX step's draws (state.py:334-432, loss.py:91-125)
    rng_z, rng_drop, rng_loss = jax.random.split(jax.random.fold_in(key, 0), 3)
    z_noise = np.asarray(jax.random.normal(rng_z, (n, CIN, RES, RES)))
    drop_u = np.asarray(jax.random.uniform(rng_drop, (n, 1)))
    len_keep = int(padded_len_keep(L, ratio))
    sigmas, noises, masks = [], [], []
    for i in range(2):
        micro_rng = jax.random.fold_in(rng_loss, i)
        s, z = jax_draws(micro_rng, (n // 2, CIN, RES, RES))
        sigmas.append(s)
        noises.append(z)
        masks.append(jax_masking.padded_random_mask(jax.random.split(micro_rng, 3)[2], n // 2, L,
                                                    L, jnp.asarray(len_keep)))
    info = MaskInfo(*(torch.from_numpy(np.concatenate([np.asarray(m[j]) for m in masks])).long()
                      for j in range(3)), torch.tensor(len_keep))
    draws = StepDraws(_t(z_noise), _t(drop_u), _t(np.concatenate(sigmas)),
                      _t(np.concatenate(noises)), info)

    ours = make_optimizer(lr, n)
    state = create_train_state(model, ours)
    state.load({"model": state_dict_from_flax(params),
                "ema": state_dict_from_flax(jstate.ema_params),
                "opt": optimizer_state_from_flax(jstate.opt_state[0])})
    train_step = make_train_step(ours, mae_loss_coef=0.1, ema_decay=decay, grad_accum=2,
                                 pad_to_max=True)
    got = train_step(state, {"x": _t(moments), "y": _t(labels), "feat": _t(feat),
                             "mask_ratio": ratio}, draws=draws)
    assert_rel(float(got["loss"]), float(metrics["loss"]), what="loss")
    assert_rel(float(got["grad_norm"]), float(metrics["grad_norm"]), what="grad norm")
    assert float(state.named(state.grads)["model.feat_embedder.weight"].abs().sum()) > 0
    for flat, tree in ((state.params, new.params), (state.ema, new.ema_params),
                       (state.opt_state.mu, new.opt_state[0].mu),
                       (state.opt_state.nu, new.opt_state[0].nu)):
        named, want = state.named(flat), state_dict_from_flax(tree)
        for k, v in want.items():
            assert_rel(named[k].numpy(), v.numpy(), what=k)


def test_reference_checkpoint_imports_the_new_embedders(pairs, tmp_path):
    """A reference ``.pt`` with ``feat_embedder`` and ``cls_token_embedder``
    loads strictly into the sampling model; the finetune import
    (``TrainState.load(strict=False)``) takes them and keeps, at its
    initialisation, the self-conditioning embedder the file lacks."""
    _, _, model, _ = pairs["feat"]
    path = str(tmp_path / "ref.pt")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "ema": sd, "args": {}}, path)
    strict = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=K,
                          model_type="DiT-S/2", dtype=torch.float32, **VARIANTS["feat"])
    load_into(strict, load_reference_checkpoint(path), strict=True)
    for k, v in strict.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    wider = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=K,
                         model_type="DiT-S/2", dtype=torch.float32, use_encoder_feat=True,
                         **VARIANTS["feat"])
    state = create_train_state(wider, make_optimizer(1e-4, 4))
    before = state.named(state.params)["model.enc_feat_embedder.weight"].clone()
    missing = state.load(load_reference_states(path), strict=False)
    assert missing == [f"{e}.model.enc_feat_embedder.{p}" for e in ("model", "ema")
                       for p in ("bias", "weight")]
    named = state.named(state.params)
    torch.testing.assert_close(named["model.enc_feat_embedder.weight"], before)
    for k in ("model.feat_embedder.weight", "model.cls_token_embedder.bias", "model.cls_token"):
        torch.testing.assert_close(named[k], sd[k], rtol=0, atol=0)


def test_eval_model_takes_a_trained_corner_state_strictly(monkeypatch):
    """The evaluation model of a config with a class token and features
    (``eval_latent.build_model``, which the train CLI's eval hook uses) has
    their parameters, so the trained EMA loads strictly; it samples without
    features, as the JAX evaluation does."""
    from maskdit_tpu_torch.eval_latent import build_model

    patch_tiny_port(monkeypatch)
    cfg = dict(precond="edm", in_size=RES, in_channels=CIN, num_classes=K,
               model_type="DiT-S/2", **VARIANTS["feat"])
    trained = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=K,
                           model_type="DiT-S/2", dtype=torch.float32, **VARIANTS["feat"])
    model = build_model(cfg, "cpu")
    model.load_state_dict(trained.state_dict())
    x, t, y, _ = inputs(42)
    with torch.no_grad():
        out = model(_t(x), _t(t), _t(y), cfg_scale=1.5)["x"]
    assert out.shape == (N, CIN, RES, RES) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the feature LMDB
# ---------------------------------------------------------------------------

ROWS, DIM, CLASSES = 12, 8, 5


@pytest.fixture(scope="module")
def feature_lmdbs(tmp_path_factory):
    """A latent LMDB of ROWS records and a feature LMDB whose labels equal
    its labels; and one whose label of record 3 differs."""
    root = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(30)
    moments = rng.normal(size=(ROWS, 2 * CIN, RES, RES)).astype(np.float32)
    labels = rng.integers(0, CLASSES, ROWS)
    feats = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    datasets.write_latent_lmdb(str(root / "latents" / "train"), moments, labels)
    features.write_feature_lmdb(str(root / "feats" / "train"), feats, labels)
    bad = labels.copy()
    bad[3] = (bad[3] + 1) % CLASSES
    features.write_feature_lmdb(str(root / "bad" / "train"), feats, bad)
    return {k: str(root / k) for k in ("latents", "feats", "bad")}


@pytest.mark.parametrize("mode", features.SAMPLE_MODES)
def test_retrieve_n_features_matches_jax(feature_lmdbs, mode):
    for seed in (0, 7):
        ours = features.retrieve_n_features(4, feature_lmdbs["feats"], DIM, CLASSES,
                                            sample_mode=mode, seed=seed)
        theirs = jax_features.retrieve_n_features(4, feature_lmdbs["feats"], DIM, CLASSES,
                                                  sample_mode=mode, seed=seed)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert ours[0].shape == (4, DIM) and (ours[1].sum(axis=1) == 1).all()


def test_dataset_joins_the_feature_lmdb_as_jax_does(feature_lmdbs):
    """Each record is ``[onehot, feature]``, as the JAX dataset's; a label
    that differs between the two LMDBs raises in both packages."""
    kw = dict(resolution=RES, num_channels=2 * CIN, feat_path=feature_lmdbs["feats"],
              feat_dim=DIM, label_dim=CLASSES)
    ours = datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw)
    theirs = jax_datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw)
    assert len(ours) == len(theirs) == ROWS
    for i in range(ROWS):
        (x, (y, f)), (tx, (ty, tf)) = ours[i], theirs[i]
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
        np.testing.assert_array_equal(f, tf)
        assert f.shape == (DIM,) and f.dtype == np.float32
    kw["feat_path"] = feature_lmdbs["bad"]
    with pytest.raises(ValueError, match="record 3"):
        datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw)[3]
    with pytest.raises(AssertionError, match="mismatch"):
        jax_datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw)[3]
    datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw)[2]


def test_loader_batches_carry_feat_as_jax(feature_lmdbs):
    kw = dict(resolution=RES, num_channels=2 * CIN, feat_path=feature_lmdbs["feats"],
              feat_dim=DIM, label_dim=CLASSES)
    ours = DataLoader(datasets.ImageNetLatentDataset(feature_lmdbs["latents"], **kw), 4, seed=3,
                      num_workers=2)
    theirs = jax_loader.DataLoader(jax_datasets.ImageNetLatentDataset(
        feature_lmdbs["latents"], **kw), 4, seed=3, num_workers=1, process_index=0,
        process_count=1)
    for a, b, _ in zip(iter(ours), iter(theirs), range(4)):
        assert a.keys() == b.keys() == {"x", "y", "feat"}
        assert a["feat"].dtype == np.float32 and a["feat"].shape == (4, DIM)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


# ---------------------------------------------------------------------------
# the attention route at the class-token lengths
# ---------------------------------------------------------------------------

MODELS = ("DiT-XL/2", "DiT-L/2", "DiT-B/2", "DiT-S/2")
# the registry and the decoder's width as released (read at import, before
# any fixture shrinks them)
CONFIGS = {m: dict(dit.DIT_CONFIGS[m]) for m in MODELS}
DECODER_HEADS, DECODER_HD = dit.DECODER_NUM_HEADS, dit.DECODER_HIDDEN_SIZE // dit.DECODER_NUM_HEADS
# (model, px, tokens, block, backward) -> (port, JAX) where the two differ:
# the port runs a kernel and the JAX package its plain attention, since the
# TPU kernels need L a multiple of 128 and the port's take ragged tiles
# (ROADMAP C7). Each such point computes the same function with sums in
# another order. The class token makes the encoder L + 1, and the decoder
# L + 1 with ``direct_cls_token`` (without it the decoder runs at L, the
# shapes tests/test_torch_512.py holds). At 256 px: the masked encoder (L
# 129) on the whole-row kernels, the unmasked one (L 257) on the whole-row
# forward without a backward and on the blocked kernels with one, the
# direct decoder (L 257, hd 32) on the whole-row kernels; at 512 px (L 513,
# 1025) both packages run plain attention at every model.
CLS_256_DIFFERENCES = {
    ("masked", "encoder", True): ("packed", "plain"),
    ("masked", "direct_decoder", True): ("packed", "plain"),
    ("unmasked", "encoder", False): ("packed", "plain"),
    ("unmasked", "direct_decoder", False): ("packed", "plain"),
    ("unmasked", "encoder", True): ("big", "plain"),
    ("unmasked", "direct_decoder", True): ("packed", "plain"),
}
NAMED_CLS_DIFFERENCES = {(model, 256, *k): v for model in MODELS
                         for k, v in CLS_256_DIFFERENCES.items()}


def cls_shapes(model):
    """(key, heads, L, head dim) of every attention call of ``model`` with a
    class token at 256 and 512 px: the encoder (L + 1), and the decoder at
    L + 1 (``direct_cls_token``; the decoder without it runs at L, the
    shapes tests/test_torch_512.py holds)."""
    cfg = CONFIGS[model]
    out = []
    for px in (256, 512):
        full = (px // 8 // cfg["patch_size"]) ** 2
        for tokens, backwards in (("masked", (True,)), ("unmasked", (False, True))):
            l_enc = (full // 2 if tokens == "masked" else full) + 1
            for backward in backwards:
                out.append(((model, px, tokens, "encoder", backward), cfg["num_heads"], l_enc,
                            cfg["hidden_size"] // cfg["num_heads"]))
                out.append(((model, px, tokens, "direct_decoder", backward), DECODER_HEADS,
                            full + 1, DECODER_HD))
    return out


@pytest.mark.parametrize("model", MODELS)
def test_route_at_the_class_token_lengths_against_the_jax_choice(model):
    """L 129 / 257 at 256 px and 513 / 1025 at 512 px: the JAX package runs
    its plain attention at every one (no kernel of it takes an L that is not
    a multiple of 128); the port runs plain where its kernels do not reach
    (every 512-px point), else the kernels NAMED_CLS_DIFFERENCES names. The
    port never runs plain where the JAX package runs a kernel."""
    got = {}
    for key, h, l, hd in cls_shapes(model):
        ours, theirs = layers.attention_route(h, l, hd, key[-1]), jax_choice(h, l, hd)
        assert not (ours == "plain" and theirs != "plain"), key
        if ours != theirs:
            got[key] = (ours, theirs)
    assert got == {k: v for k, v in NAMED_CLS_DIFFERENCES.items() if k[0] == model}
    assert {jax_choice(h, l, hd) for _, h, l, hd in cls_shapes(model)} == {"plain"}


# ---------------------------------------------------------------------------
# chip_smoke.py's model-corner phases: their configs, and their CLI runs on
# the CPU at tiny widths
# ---------------------------------------------------------------------------

def test_chip_smoke_model_corner_configs_are_the_released_ones_plus_the_corners():
    """[train-cls-feat]'s config is chip_smoke.TRAIN_CONFIG (the released
    256-px training config) with a class token, FEATURE_DIM features from
    the feature LMDB and TRAIN_STEPS_CLS steps; [sample-cls]'s is
    configs/test/maskdit-256.yaml's model with a class token and
    ``self_cond``."""
    import chip_smoke
    from maskdit_tpu.utils import config as jax_config

    cfg, base = chip_smoke.TRAIN_CLS_CONFIG, chip_smoke.TRAIN_CONFIG
    assert cfg["data"] == {**base["data"], "feat_path": chip_smoke.FEATURE_ROOT}
    assert cfg["model"] == {**base["model"], "pad_cls_token": True,
                            "ext_feature_dim": chip_smoke.FEATURE_DIM}
    assert cfg["train"] == {**base["train"], "max_num_steps": chip_smoke.TRAIN_STEPS_CLS}
    released = jax_config.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "test", "maskdit-256.yaml")).to_container()
    assert chip_smoke.SAMPLE_CLS_CONFIG == {"model": {**released["model"], "pad_cls_token": True,
                                                      "self_cond": True}}


def test_chip_smoke_model_corner_phases_run_on_the_cpu(tiny_xl, tmp_path):
    """[train-cls-feat]'s and [sample-cls]'s CLI runs at tiny widths (XL/2's
    head dim of 72 on 2 heads): one train step on TRAIN_CLS_CONFIG over a
    latent LMDB and its feature LMDB (the encoder at 128 kept tokens + the
    class token, the decoder at 256), and the generate CLI on
    SAMPLE_CLS_CONFIG (each evaluation's encoder at 257 tokens twice: the
    self-conditioning feature, then the forward)."""
    import json

    import chip_smoke
    from maskdit_tpu_torch import generate
    from maskdit_tpu_torch.train import cli

    rng = np.random.default_rng(60)
    labels = rng.integers(0, 1000, 4)
    datasets.write_latent_lmdb(str(tmp_path / "latents" / "train"),
                               rng.normal(size=(4, 8, 32, 32)).astype(np.float32), labels)
    features.write_feature_lmdb(str(tmp_path / "feats" / "train"),
                                rng.normal(size=(4, chip_smoke.FEATURE_DIM)).astype(np.float32),
                                labels)
    path = tmp_path / "train-cls.json"
    path.write_text(json.dumps(chip_smoke.TRAIN_CLS_CONFIG))
    out = cli.main(["--config", str(path), "--results_dir", str(tmp_path / "results"),
                    "--device", "cpu", "--num_workers", "1", "--max_steps", "1",
                    "train.batchsize=2", f"data.root={tmp_path / 'latents'}",
                    f"data.feat_path={tmp_path / 'feats'}"])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert tiny_xl == [("packed", (2, 129, 3 * 144)), ("packed", (2, 256, 3 * 64))]
    del tiny_xl[:]
    state = out["state"].named(out["state"].ema)
    model = create_model("edm", img_resolution=32, img_channels=4, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1,
                         pad_cls_token=True, use_encoder_feat=True)
    sd = model.state_dict()
    sd.update({k: v for k, v in state.items() if k in sd})
    torch.save({"ema": sd}, tmp_path / "cls.pt")
    config = tmp_path / "sample-cls.json"
    config.write_text(json.dumps(chip_smoke.SAMPLE_CLS_CONFIG))
    result = generate.main(["--ckpt_path", str(tmp_path / "cls.pt"), "--outdir",
                            str(tmp_path / "out"), "--no_decode", "--config", str(config),
                            "--seeds", "0-1", "--cfg_scale", "1.5", "--num_steps", "2",
                            "--device", "cpu"])
    assert result["images"] == 2
    assert np.isfinite(np.load(tmp_path / "out" / "latents_000000.npy")).all()
    # 3 evaluations x (encode: 1 block, forward: 1 encoder + 1 decoder block)
    assert tiny_xl == [("packed", (4, 257, 3 * 144)), ("packed", (4, 257, 3 * 144)),
                       ("packed", (4, 256, 3 * 64))] * 3
