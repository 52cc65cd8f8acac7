"""The port's sampling slice end to end on the CPU, at tiny dims.

``make_sample_fn`` of both packages samples the same injected latents and
labels with the same weights (fp32, 4 EDM steps, CFG 1.5: 7 evaluations of
the tiny model); then the port's CLI runs from a reference-layout ``.pt``,
writing latents or, through a full-config SD-VAE with random weights, PNGs;
and ``eval_latent`` runs from the checkpoint to an FID.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.sampling.generate import SamplerConfig as JaxSamplerConfig
from maskdit_tpu.sampling.generate import make_sample_fn as jax_make_sample_fn
from maskdit_tpu_torch import eval_latent, generate
from maskdit_tpu_torch import fid as fid_cli
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.sampling.generate import (
    SamplerConfig,
    generate_with_params,
    make_sample_fn,
    to_uint8,
)
from maskdit_tpu_torch.utils.png import read_png, write_png
from maskdit_tpu_torch.utils.port import load_vae, state_dict_from_flax
from tests.test_torch_model import MODEL_KW, patch_tiny_port
from tests.test_torch_model_corners import assert_rel
from tests.test_torch_vae import write_random_vae

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
        lambda model, cfg: lambda z, y, g, feat=None: z + y.argmax(dim=1)[:, None, None, None],
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


class PortDraws:
    """The JAX sampler's per-seed generator, replaced by the port's draws:
    the two packages' streams differ (utils/rng.py), so a CLI run is held
    to the JAX ``generate_with_params`` given the same latents and labels."""

    def __init__(self, seeds):
        from maskdit_tpu_torch.utils.rng import StackedRandomGenerator

        self.g = StackedRandomGenerator("cpu", seeds)

    def randn(self, size):
        return jnp.asarray(self.g.randn(size).numpy())

    def randint(self, high, size):
        return jnp.asarray(self.g.randint(high, size).numpy())


FEAT_DIM = 16
# the CLI's latents against the JAX sampler's from the same weights and
# draws, fp32: within this share of max|ref| (the model parity bound of
# tests/test_torch_model_corners.py; a random model's latents reach ~100,
# and the elementwise TOL fails only near zero, where two steps carry the
# sums' last bits)
CLI_REL = 1e-5


def corner_nets(seed, **corner):
    """A JAX model at MODEL_KW with the model keys ``corner``, random
    weights, and their reference-layout state dict."""
    from tests.test_torch_model_corners import _init_all

    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **MODEL_KW, **corner)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        jnp.zeros((1, FEAT_DIM)), method=_init_all))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32), shapes)
    return jax_model, params, state_dict_from_flax(params)


def jax_latents(monkeypatch, jax_model, params, seeds, num_steps, cfg_scale, **kw):
    """The JAX ``generate_with_params``' latents for ``seeds``, from the
    port's per-seed draws."""
    from maskdit_tpu.sampling import generate as jax_gen

    monkeypatch.setattr(jax_gen, "StackedRandomGenerator", PortDraws)
    out = jax_gen.generate_with_params(
        jax_model, params, seeds, None, JaxSamplerConfig(num_steps=num_steps, cfg_scale=cfg_scale),
        max_batch_size=64, **kw)
    monkeypatch.undo()
    return out


def write_model_config(path, **model):
    path.write_text(json.dumps({"model": {
        "precond": "edm", "model_type": "DiT-S/2", "in_size": RES, "in_channels": CIN,
        "num_classes": K, "use_decoder": True, "mae_loss_coef": 0.1, **model}}))
    return str(path)


@pytest.mark.parametrize("key,value,default", [("pad_cls_token", "True", "False"),
                                               ("ext_feature_dim", "16", "0")])
def test_cli_raises_on_model_keys_it_does_not_build(nets, tmp_path, monkeypatch, key, value,
                                                    default):
    """--config's model keys the JAX CLI reads (generate.py:150-151), which
    the port once refused: with the key set the CLI builds that model (a
    class token; a feature embedder, which without --feat_path conditions
    on nothing, as in the JAX CLI) and samples what the JAX
    ``generate_with_params`` samples from the same weights and draws; at
    the default it samples the model of ``nets``."""
    _, _, model = nets
    argv = ["--no_decode", "--seeds", "0-1", "--num_steps", "2", "--fp32", "--device", "cpu"]
    for v in (value, default):
        corner = {key: v == "True" if key == "pad_cls_token" else int(v)}
        jax_model, params, state = corner_nets(20, **corner) if v == value else (
            None, None, model.state_dict())
        ckpt = tmp_path / f"tiny-{v}.pt"
        torch.save({"ema": state}, ckpt)
        config = write_model_config(tmp_path / f"model-{v}.json", **corner)
        outdir = tmp_path / f"samples-{v}"
        result = generate.main([*argv, "--ckpt_path", str(ckpt), "--outdir", str(outdir),
                                "--config", config])
        assert result["images"] == 2
        z = np.load(outdir / "latents_000000.npy")
        assert z.shape == (2, CIN, RES, RES) and np.isfinite(z).all()
        if v == value:
            want = jax_latents(monkeypatch, jax_model, params, [0, 1], 2, None)
            assert_rel(z, want, CLI_REL)


def test_cli_samples_self_conditioning_and_class_token_from_the_config(nets, tmp_path,
                                                                      monkeypatch):
    """``model.self_cond`` in --config (the key the reference CLI reads, in
    no released config) builds the encoder-feature model: each evaluation
    runs ``encode`` first. With a class token and CFG the CLI's latents
    equal the JAX ones."""
    corner = dict(pad_cls_token=True, use_encoder_feat=True)
    jax_model, params, state = corner_nets(21, **corner)
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": state}, ckpt)
    config = write_model_config(tmp_path / "model.json", pad_cls_token=True, self_cond=True)
    outdir = tmp_path / "out"
    generate.main(["--ckpt_path", str(ckpt), "--outdir", str(outdir), "--config", config,
                   "--no_decode", "--seeds", "0-2", "--num_steps", "2", "--cfg_scale", "1.5",
                   "--fp32", "--device", "cpu"])
    want = jax_latents(monkeypatch, jax_model, params, [0, 1, 2], 2, 1.5)
    assert_rel(np.load(outdir / "latents_000000.npy"), want, CLI_REL)


@pytest.fixture(scope="module")
def feature_lmdb(tmp_path_factory):
    from maskdit_tpu_torch.data.features import write_feature_lmdb

    root = tmp_path_factory.mktemp("feats")
    rng = np.random.default_rng(22)
    write_feature_lmdb(str(root / "train"), rng.normal(size=(10, FEAT_DIM)).astype(np.float32),
                       rng.integers(0, K, 10))
    return str(root)


@pytest.mark.parametrize("mode", ["rand_full", "rand_y"])
def test_cli_feat_path_matches_jax_feat_fn(nets, tmp_path, monkeypatch, feature_lmdb, mode):
    """--feat_path / --sample_mode: each batch is conditioned on the rows
    ``retrieve_n_features`` draws (seeded by its first seed), with their
    labels in place of the per-seed ones; the latents equal the JAX
    ``generate_with_params(feat_fn=)``'s on the same LMDB. --class_idx with
    --feat_path is refused, as the JAX CLI refuses it."""
    from maskdit_tpu.data.features import retrieve_n_features as jax_retrieve

    corner = dict(pad_cls_token=True, ext_feature_dim=FEAT_DIM)
    jax_model, params, state = corner_nets(23, **corner)
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": state}, ckpt)
    config = write_model_config(tmp_path / "model.json", **corner)
    argv = ["--ckpt_path", str(ckpt), "--config", config, "--no_decode", "--seeds", "3-6",
            "--num_steps", "2", "--cfg_scale", "1.5", "--fp32", "--device", "cpu",
            "--feat_path", feature_lmdb, "--sample_mode", mode]
    generate.main([*argv, "--outdir", str(tmp_path / "out")])
    feat_fn = lambda seeds: jax_retrieve(len(seeds), feature_lmdb, FEAT_DIM, K,
                                         sample_mode=mode, seed=int(seeds[0]))
    want = jax_latents(monkeypatch, jax_model, params, [3, 4, 5, 6], 2, 1.5, feat_fn=feat_fn)
    assert_rel(np.load(tmp_path / "out" / "latents_000003.npy"), want, CLI_REL)
    with pytest.raises(SystemExit):
        generate.main([*argv, "--outdir", str(tmp_path / "refused"), "--class_idx", "2"])
    assert not (tmp_path / "refused").exists()


def test_cli_label_dict_samples_into_the_class_folder(nets, tmp_path):
    """--label_dict with --class_idx and --results_dir: no --outdir, the
    samples of class 3 go to <results_dir>/<its name>/ (JAX
    ``resolve_class_outdir``); --label_dict without --class_idx, and neither
    --outdir nor --label_dict, are refused."""
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    labels = tmp_path / "labels.json"
    labels.write_text(json.dumps({"3": ["n01440764", "tench"], "4": ["n01443537", "goldfish"]}))
    argv = ["--ckpt_path", str(ckpt), "--no_decode", "--seeds", "0-1", "--num_steps", "2",
            "--fp32", "--device", "cpu", "--model_type", "DiT-S/2", "--image_size", str(RES),
            "--num_classes", str(K), "--use_decoder", "True", "--mae_loss_coef", "0.1"]
    results = tmp_path / "results"
    generate.main([*argv, "--label_dict", str(labels), "--class_idx", "3",
                   "--results_dir", str(results)])
    assert sorted(os.listdir(results)) == ["tench"]
    assert sorted(os.listdir(results / "tench")) == ["latents_000000.npy", "log.txt"]
    cls = np.load(results / "tench" / "latents_000000.npy")
    from maskdit_tpu.sampling.generate import resolve_class_outdir as jax_resolve
    from maskdit_tpu_torch.sampling.generate import resolve_class_outdir

    assert resolve_class_outdir(str(labels), 4, "r") == jax_resolve(str(labels), 4, "r")
    # the class's samples are those of --class_idx 3 with --outdir
    generate.main([*argv, "--class_idx", "3", "--outdir", str(tmp_path / "plain")])
    np.testing.assert_array_equal(cls, np.load(tmp_path / "plain" / "latents_000000.npy"))
    for bad in (["--label_dict", str(labels), "--results_dir", str(results)], []):
        with pytest.raises(SystemExit):
            generate.main([*argv, *bad])


@pytest.fixture(scope="module")
def vae_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vae") / "autoencoder_kl.pth")
    write_random_vae(path)
    return path


def test_cli_writes_pngs_of_the_decoded_latents(nets, tmp_path, vae_path, capsys):
    """Without --no_decode the CLI decodes with the SD-VAE of
    --pretrained_path (the full config, random weights) and writes
    ``{seed:06d}.png``: ``to_uint8`` of the VAE's decode of the very latents
    the same CLI samples with --no_decode."""
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    argv = ["--ckpt_path", str(ckpt), "--seeds", "0-4", "--max_batch_size", "5",
            "--cfg_scale", "1.5", "--num_steps", "3", "--fp32", "--device", "cpu",
            "--model_type", "DiT-S/2", "--image_size", str(RES), "--num_classes", str(K),
            "--use_decoder", "True", "--mae_loss_coef", "0.1"]
    latents = generate.main([*argv, "--outdir", str(tmp_path / "z"), "--no_decode"])
    assert latents["decode_seconds"] == 0.0
    result = generate.main([*argv, "--outdir", str(tmp_path / "png"),
                            "--pretrained_path", vae_path])
    assert result["images"] == 5 and 0 < result["decode_seconds"] < result["seconds"]
    assert "decode" in capsys.readouterr().out
    files = sorted(os.listdir(tmp_path / "png"))
    assert files == [f"{s:06d}.png" for s in range(5)] + ["log.txt"]
    z = torch.from_numpy(np.load(tmp_path / "z" / "latents_000000.npy"))
    want = to_uint8(load_vae(vae_path).decode(z).numpy())
    assert want.shape == (5, 8 * RES, 8 * RES, 3) and len(np.unique(want)) > 10
    for s in range(5):
        np.testing.assert_array_equal(read_png(str(tmp_path / "png" / f"{s:06d}.png")), want[s])


def test_cli_subdirs_writes_pngs_under_thousand_seed_folders(nets, tmp_path, vae_path):
    """--subdirs: seed s goes to ``{s - s % 1000:06d}/{s:06d}.png``, as the
    JAX ``save_images`` writes it."""
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict()}, ckpt)
    out = tmp_path / "png"
    generate.main(["--ckpt_path", str(ckpt), "--outdir", str(out), "--subdirs", "--seeds",
                   "999-1000", "--num_steps", "1", "--fp32", "--device", "cpu",
                   "--model_type", "DiT-S/2", "--image_size", str(RES), "--num_classes", str(K),
                   "--use_decoder", "True", "--mae_loss_coef", "0.1",
                   "--pretrained_path", vae_path])
    assert sorted(os.listdir(out)) == ["000000", "001000", "log.txt"]
    assert os.listdir(out / "000000") == ["000999.png"]
    assert os.listdir(out / "001000") == ["001000.png"]
    assert read_png(str(out / "001000" / "001000.png")).shape == (8 * RES, 8 * RES, 3)


@pytest.mark.parametrize("skip_fid", [False, True])
def test_eval_latent_end_to_end(nets, tmp_path, vae_path, skip_fid):
    """config + checkpoint -> PNGs -> FID against ``eval.ref_path`` (reference
    statistics of other PNGs, from the port's ``fid ref``), random detector."""
    _, _, model = nets
    ckpt = tmp_path / "tiny.pt"
    torch.save({"ema": model.state_dict(), "args": {}}, ckpt)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(12)
    for i in range(4):
        write_png(str(data / f"{i}.png"), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    stats = str(tmp_path / "ref.npz")
    fid_cli.main(["ref", "--data", str(data), "--dest", stats, "--random_detector",
                  "--batch", "4", "--device", "cpu"])
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "model": {"precond": "edm", "model_type": "DiT-S/2", "in_size": RES,
                  "in_channels": CIN, "num_classes": K, "use_decoder": True,
                  "ext_feature_dim": 0, "pad_cls_token": False, "mae_loss_coef": 0.1},
        "eval": {"batchsize": 4, "ref_path": stats},
    }))
    argv = ["--config", str(config), "--ckpt_path", str(ckpt), "--outdir", str(tmp_path / "out"),
            "--seeds", "0-3", "--cfg_scale", "1.5", "--num_steps", "2", "--max_batch_size", "2",
            "--num_expected", "4", "--fid_batch_size", "4", "--pretrained_path", vae_path,
            "--random_detector", "--device", "cpu"]
    out = eval_latent.main(argv + ["--skip_fid"] * skip_fid)
    assert out["outdir"] == str(tmp_path / "out" / "edm-steps2-cfg1.5")
    assert sorted(os.listdir(out["outdir"])) == [f"{s:06d}.png" for s in range(4)]
    assert read_png(os.path.join(out["outdir"], "000003.png")).shape == (64, 64, 3)
    if skip_fid:
        assert out["fid"] is None
    else:
        assert np.isfinite(out["fid"]) and out["fid"] > 0


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
