"""The port's EDMPrecond (MaskDiT with decoder) against the JAX package's.

Both run fp32 on the CPU at the tiny dims of the ``tiny_dit`` fixture
(depth 2, width 64, 4 heads, decoder 2 x 64 x 4), with every JAX parameter
drawn from a seeded normal (std 0.05) and carried across through
``state_dict_from_flax``. The bound is that of tests/test_model_oracle.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.utils.port import export_maskdit
from maskdit_tpu_torch.models import create_model, dit
from maskdit_tpu_torch.utils.port import state_dict_from_flax

ATOL = 3e-5
RES, CIN, K = 8, 4, 6
MODEL_KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K,
                model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1)


def patch_tiny_port(mp: pytest.MonkeyPatch) -> None:
    """The port's twin of conftest's _patch_tiny_dit."""
    mp.setitem(dit.DIT_CONFIGS, "DiT-S/2",
               dict(depth=2, hidden_size=64, patch_size=2, num_heads=4))
    mp.setattr(dit, "DECODER_HIDDEN_SIZE", 64)
    mp.setattr(dit, "DECODER_DEPTH", 2)
    mp.setattr(dit, "DECODER_NUM_HEADS", 4)


@pytest.fixture(scope="module")
def models(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **MODEL_KW)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        )
    )["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32), shapes
    )
    model = create_model("edm", dtype=torch.float32, **MODEL_KW).eval()
    model.load_state_dict(state_dict_from_flax(params))
    yield jax_model, params, model
    mp.undo()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, CIN, RES, RES)).astype(np.float32)
    sigma = np.array([0.4, 2.7], np.float32)
    y = np.eye(K, dtype=np.float32)[[1, 4]]
    return x, sigma, y


@pytest.mark.parametrize("cfg_scale", [None, 1.5])
def test_edm_precond_matches_jax(models, cfg_scale):
    jax_model, params, model = models
    x, sigma, y = _inputs(seed=1 if cfg_scale is None else 2)
    apply = jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a, cfg_scale=cfg_scale))
    theirs = apply(params, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(y))["x"]
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y),
                     cfg_scale=cfg_scale)["x"]
    assert ours.shape == (2, CIN, RES, RES) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=ATOL)


def test_bf16_forward_tracks_fp32(models):
    """The bf16 compute path runs and stays near fp32 (the chip runs it)."""
    _, _, model = models
    bf16 = create_model("edm", dtype=torch.bfloat16, **MODEL_KW).eval()
    bf16.load_state_dict(model.state_dict())
    x, sigma, y = _inputs(seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y))
    with torch.no_grad():
        ref = model(*args, cfg_scale=1.5)["x"]
        out = bf16(*args, cfg_scale=1.5)["x"]
    assert out.dtype == torch.float32  # the EDM algebra stays fp32
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel < 5e-2, rel


def test_state_dict_from_flax_equals_export_maskdit(models):
    _, params, model = models
    ours = state_dict_from_flax(params)
    theirs = export_maskdit(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # the port's own parameter names are exactly the reference's
    assert sorted(ours) == sorted(model.state_dict())


def test_masked_forward_waits_for_training_slice(models):
    """The training slice has arrived: the masked forward runs and returns
    the mask beside x (its parity with JAX: test_torch_masked_model.py)."""
    _, _, model = models
    x, sigma, y = _inputs(seed=4)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y),
                    mask_ratio=0.5, train=True, generator=torch.Generator().manual_seed(0))
    assert out["x"].shape == (2, CIN, RES, RES) and torch.isfinite(out["x"]).all()
    assert out["mask"].shape == (2, (RES // 2) ** 2)
    assert int(out["mask"].sum()) == 2 * (RES // 2) ** 2 // 2
