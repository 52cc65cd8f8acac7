"""The port's sampling slice end to end on the CPU, at tiny dims.

``make_sample_fn`` of both packages samples the same injected latents and
labels with the same weights (fp32, 4 EDM steps, CFG 1.5: 7 evaluations of
the tiny model); then the port's CLI runs from a reference-layout ``.pt``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.sampling.generate import SamplerConfig as JaxSamplerConfig
from maskdit_tpu.sampling.generate import make_sample_fn as jax_make_sample_fn
from maskdit_tpu_torch import generate
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.sampling.generate import (
    SamplerConfig,
    generate_with_params,
    make_sample_fn,
)
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_model import MODEL_KW, patch_tiny_port

# 7 evaluations of a random-weight model in fp32, summed in other orders
# on the two sides: the sampler's own bound (1e-4 / 1e-5) widened 10x in atol
TOL = dict(rtol=1e-4, atol=1e-4)
RES, CIN, K = MODEL_KW["img_resolution"], MODEL_KW["img_channels"], MODEL_KW["num_classes"]


@pytest.fixture(scope="module")
def nets(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **MODEL_KW)
    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
            jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        )
    )["params"]
    rng = np.random.default_rng(10)
    params = jax.tree.map(
        lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32), shapes
    )
    model = create_model("edm", dtype=torch.float32, **MODEL_KW).eval()
    model.load_state_dict(state_dict_from_flax(params))
    yield jax_model, params, model
    mp.undo()


def test_make_sample_fn_matches_jax(nets):
    jax_model, params, model = nets
    rng = np.random.default_rng(11)
    latents = rng.normal(size=(3, CIN, RES, RES)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[[0, 3, 5]]
    theirs = jax_make_sample_fn(
        jax_model, params, JaxSamplerConfig(num_steps=4, cfg_scale=1.5)
    )(jnp.asarray(latents), jnp.asarray(labels), jax.random.PRNGKey(0))
    ours = make_sample_fn(model, SamplerConfig(num_steps=4, cfg_scale=1.5))(
        torch.from_numpy(latents), torch.from_numpy(labels)
    )
    assert ours.shape == (3, CIN, RES, RES)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_latents_do_not_depend_on_batching(nets, monkeypatch):
    """A seed's initial latents and label are the same whatever the batch
    size and rank count (the StackedRandomGenerator contract, reference
    sample.py:232). The sampler is replaced by one that returns what it is
    given: batched matmuls on the CPU round differently per batch size, and
    the last Heun step of a random model amplifies that past any bound."""
    _, _, model = nets
    from maskdit_tpu_torch.sampling import generate as gen_mod

    monkeypatch.setattr(
        gen_mod, "make_sample_fn",
        lambda model, cfg: lambda z, y, g: z + y.argmax(dim=1)[:, None, None, None],
    )
    cfg = SamplerConfig(num_steps=2, cfg_scale=1.5)
    whole = generate_with_params(model, range(6), None, cfg, max_batch_size=6)
    parts = [
        generate_with_params(model, range(6), None, cfg, max_batch_size=2,
                             rank=r, world=2)
        for r in range(2)
    ]
    # 4 batches ([0,1], [2,3], [4], [5]), rank-strided: rank 0 holds seeds
    # 0, 1, 4 and rank 1 holds 2, 3, 5
    np.testing.assert_array_equal(parts[0], whole[[0, 1, 4]])
    np.testing.assert_array_equal(parts[1], whole[[2, 3, 5]])
    assert len({whole[i].tobytes() for i in range(6)}) == 6


@pytest.mark.parametrize("model_flags", ["flags", "config"])
def test_cli_writes_latents_from_reference_checkpoint(nets, tmp_path, model_flags):
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict(), "args": {"note": "reference layout"}}, ckpt)
    outdir = tmp_path / "out"
    argv = [
        "--ckpt_path", str(ckpt), "--outdir", str(outdir), "--no_decode",
        "--seeds", "0-4", "--max_batch_size", "3", "--cfg_scale", "1.5",
        "--num_steps", "3", "--fp32", "--device", "cpu",
    ]
    if model_flags == "flags":
        argv += ["--model_type", "DiT-S/2", "--image_size", str(RES),
                 "--num_classes", str(K), "--use_decoder", "True",
                 "--mae_loss_coef", "0.1"]
    else:
        config = tmp_path / "model.yaml"
        config.write_text(
            "model:\n  precond: edm\n  model_type: DiT-S/2\n"
            f"  in_size: {RES}\n  in_channels: {CIN}\n  num_classes: {K}\n"
            "  use_decoder: True\n  mae_loss_coef: 0.1\n"
        )
        argv += ["--config", str(config)]
    result = generate.main(argv)
    assert result["images"] == 5
    files = sorted(f for f in os.listdir(outdir) if f.endswith(".npy"))
    assert files == ["latents_000000.npy", "latents_000003.npy"]
    z = np.concatenate([np.load(outdir / f) for f in files])
    assert z.shape == (5, CIN, RES, RES) and np.isfinite(z).all()


@pytest.mark.parametrize("key,value,default", [("pad_cls_token", "True", "False"),
                                               ("ext_feature_dim", "16", "0")])
def test_cli_raises_on_model_keys_it_does_not_build(nets, tmp_path, key, value, default):
    """--config's model keys the JAX CLI reads (generate.py:150-151) and the
    port does not build yet raise, where the port would otherwise sample a
    different model; at their defaults the CLI samples."""
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    argv = ["--ckpt_path", str(ckpt), "--no_decode", "--seeds", "0-1", "--num_steps", "2",
            "--fp32", "--device", "cpu"]
    for v, outdir in ((value, tmp_path / "raises"), (default, tmp_path / "samples")):
        config = tmp_path / f"model-{v}.yaml"
        config.write_text(
            "model:\n  precond: edm\n  model_type: DiT-S/2\n"
            f"  in_size: {RES}\n  in_channels: {CIN}\n  num_classes: {K}\n"
            f"  use_decoder: True\n  mae_loss_coef: 0.1\n  {key}: {v}\n"
        )
        run = lambda: generate.main([*argv, "--outdir", str(outdir), "--config", str(config)])
        if v == value:
            with pytest.raises(NotImplementedError, match=f"model.{key}"):
                run()
            assert not outdir.exists()
        else:
            assert run()["images"] == 2


def test_cli_without_no_decode_says_vae_is_not_ported(nets, tmp_path):
    with pytest.raises(NotImplementedError, match="VAE"):
        generate.main(["--ckpt_path", str(tmp_path / "none.pt"),
                       "--outdir", str(tmp_path), "--device", "cpu"])


def test_to_uint8_and_save_images_match_jax(tmp_path):
    from PIL import Image

    from maskdit_tpu.sampling import generate as jax_gen
    from maskdit_tpu_torch.sampling import generate as gen

    imgs = np.random.default_rng(0).uniform(-1.2, 1.2, size=(3, 3, 8, 8)).astype(np.float32)
    arr = gen.to_uint8(imgs)
    np.testing.assert_array_equal(arr, jax_gen.to_uint8(imgs))
    gen.save_images(arr, [0, 1, 1001], str(tmp_path), subdirs=True)
    loaded = np.array(Image.open(tmp_path / "001000" / "001001.png"))
    np.testing.assert_array_equal(loaded, arr[2])
