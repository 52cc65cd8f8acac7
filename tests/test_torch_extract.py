"""The port's data CLIs against the JAX package's, and the port's train CLI
on both released configs' data categories, on the CPU at tiny sizes.

- ``python -m maskdit_tpu_torch.extract_latent`` and the repo's
  extract_latent.py on the same PNG tree (32 px, ``--xflip``, a partial
  last batch) with one ``.pth`` of random SD-VAE weights, at a smaller
  ddconfig injected on both sides through each module's ``AutoencoderKL``:
  the same keys, ``y-`` and ``length`` exact, each ``z-`` within 1e-4 of
  max|ref| (the encoders sum in other orders; measured ~1e-6).
- ``python -m maskdit_tpu_torch.lmdb2wds`` and the repo's lmdb2wds.py on
  that LMDB: the same shards, byte for byte.
- ``python -m maskdit_tpu_torch.train`` on configs/train/imagenet256-latent.yaml
  (``lmdb``) and configs/train/imagenet512-latent.yaml (``webdataset``,
  indexed and with ``data.streaming=true``) as released but for
  ``data.root`` (and the tiny model, batch and one step), and
  configs/train/synthetic-smoke.yaml with ``data.category=lmdb``.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extract_latent as jax_extract
import lmdb2wds as jax_lmdb2wds
from maskdit_tpu.data import lmdb_lite as jax_lmdb
from maskdit_tpu.models import vae as jvae
from maskdit_tpu_torch import extract_latent, lmdb2wds
from maskdit_tpu_torch.data.datasets import write_latent_lmdb
from maskdit_tpu_torch.data.lmdb_lite import Reader
from maskdit_tpu_torch.data.wds import write_wds_shards
from maskdit_tpu_torch.models import dit
from maskdit_tpu_torch.models.vae import AutoencoderKL
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.utils.png import write_png
from tests.test_torch_model import patch_tiny_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs", "train")
# three downsamplings (32 px -> 4 x 4 latents) at the narrowest width
# GroupNorm's 32 groups allow
SMALL = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
REL = 1e-4


def small_jax_vae():
    class SmallVAE(jvae.AutoencoderKL):
        def setup(self):
            self.encoder = jvae.Encoder(z_channels=self.z_channels, **SMALL)
            self.decoder = jvae.Decoder(**SMALL)
            self.quant_conv = jvae.Conv(2 * self.embed_dim, 1)
            self.post_quant_conv = jvae.Conv(self.z_channels, 1)

    return SmallVAE()


@pytest.fixture(scope="module")
def vae_pth(tmp_path_factory):
    """Random weights of the small ddconfig in the released layout;
    GroupNorm scales about 1 so the signal keeps its size."""
    path = str(tmp_path_factory.mktemp("vae") / "autoencoder_kl.pth")
    g = torch.Generator().manual_seed(0)
    state = AutoencoderKL(**SMALL).state_dict()
    for k, v in state.items():
        v.copy_(torch.randn(v.shape, generator=g) * 0.05 + (1.0 if "norm" in k and
                                                             k.endswith("weight") else 0.0))
    torch.save(state, path)
    return path


def _image_tree(root) -> None:
    rng = np.random.default_rng(0)
    sizes = [(40, 48), (64, 36), (80, 80), (33, 90)]
    for i, (h, w) in enumerate(sizes):
        cls = os.path.join(root, "train", ("n01", "n02")[i % 2])
        os.makedirs(cls, exist_ok=True)
        grid = rng.uniform(0, 255, (6, 6, 3))
        smooth = grid[np.arange(h) * 6 // h][:, np.arange(w) * 6 // w]
        write_png(os.path.join(cls, f"img{i}.png"), np.clip(
            smooth + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def extracted(tmp_path_factory, vae_pth):
    """Both CLIs on copies of one PNG tree (each builds its own raw-image
    cache beside its tree): the port's and the JAX package's LMDB paths."""
    base = tmp_path_factory.mktemp("extract")
    _image_tree(str(base / "data_ours"))
    shutil.copytree(base / "data_ours", base / "data_theirs")
    args = ["--data_name", "tiny", "--ckpt", vae_pth, "--resolution", "32",
            "--batch_size", "3", "--xflip"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(extract_latent, "AutoencoderKL", lambda: AutoencoderKL(**SMALL))
        result = extract_latent.main([*args, "--data_dir", str(base / "data_ours"),
                                      "--outdir", str(base / "ours"), "--device", "cpu"])
        mp.setattr(jax_extract, "AutoencoderKL", small_jax_vae)
        mp.setattr(sys, "argv", ["extract_latent.py", *args, "--data_dir",
                                 str(base / "data_theirs"), "--outdir", str(base / "theirs")])
        jax_extract.main()
    finally:
        mp.undo()
    sub = os.path.join("tiny_32_latent_lmdb", "train")
    return result, str(base / "ours" / sub), str(base / "theirs" / sub)


def test_extract_latent_matches_the_jax_cli(extracted):
    result, ours, theirs = extracted
    assert result["count"] == 8 and result["reader"] == "native" and result["outdir"] == ours
    a, b = Reader(ours), jax_lmdb.Reader(theirs)
    keys = [k for k, _ in a.items()]
    assert keys == [k for k, _ in b.items()]
    assert a.get(b"length") == b.get(b"length") == b"8"
    for i in range(8):
        assert a.get(f"y-{i}") == b.get(f"y-{i}")
        z, ref = (np.frombuffer(r.get(f"z-{i}"), np.float32) for r in (a, b))
        assert z.shape == (8 * 4 * 4,)
        assert np.abs(z - ref).max() <= REL * np.abs(ref).max(), i
    # the flipped pass: labels repeat, moments differ
    assert [a.get(f"y-{i}") for i in range(4)] == [a.get(f"y-{i}") for i in range(4, 8)]
    assert a.get("z-0") != a.get("z-4")


def test_lmdb2wds_matches_the_jax_cli(extracted, tmp_path, monkeypatch):
    _, ours, _ = extracted
    args = ["--datadir", os.path.dirname(ours), "--resolution", "4", "--maxcount", "3"]
    paths = lmdb2wds.main([*args, "--outdir", str(tmp_path / "ours")])
    monkeypatch.setattr(sys, "argv", ["lmdb2wds.py", *args, "--outdir", str(tmp_path / "theirs")])
    jax_lmdb2wds.main()
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert [os.path.basename(p) for p in paths] == names == [
        f"latent_imagenet_32_train-{i:04d}.tar" for i in range(3)]
    for name in names:
        assert (tmp_path / "ours" / name).read_bytes() == (tmp_path / "theirs" / name).read_bytes()


# -- the train CLI on the released configs' data ---------------------------

@pytest.fixture
def tiny_xl(monkeypatch):
    """DiT-XL/2 shrunk (head dim 72 on 2 heads, 1 block; decoder 1 block)."""
    monkeypatch.setitem(dit.DIT_CONFIGS, "DiT-XL/2",
                        dict(depth=1, hidden_size=144, patch_size=2, num_heads=2))
    monkeypatch.setattr(dit, "DECODER_HIDDEN_SIZE", 64)
    monkeypatch.setattr(dit, "DECODER_DEPTH", 1)
    monkeypatch.setattr(dit, "DECODER_NUM_HEADS", 2)
    patch_tiny_port(monkeypatch)


def _latent_lmdb(root: str, res: int, n: int = 4) -> str:
    rng = np.random.default_rng(res)
    write_latent_lmdb(os.path.join(root, "train"),
                      rng.normal(size=(n, 8, res, res)).astype(np.float32),
                      rng.integers(0, 16, n))
    return root


def _shards(root: str, res: int, n: int = 4) -> str:
    rng = np.random.default_rng(res)
    write_wds_shards([(f"{i:07d}", rng.normal(size=(8, res, res)).astype(np.float32), i)
                      for i in range(n)], root, maxcount=2)
    return root


CASES = {
    "imagenet256-lmdb": ("imagenet256-latent.yaml", _latent_lmdb, 32, [], "native LMDB reader"),
    "imagenet512-webdataset": ("imagenet512-latent.yaml", _shards, 64, [], "4 samples"),
    "imagenet512-streaming": ("imagenet512-latent.yaml", _shards, 64, ["data.streaming=true"],
                              "streamed shards"),
    "smoke-lmdb": ("synthetic-smoke.yaml", _latent_lmdb, 16, ["data.category=lmdb"],
                   "native LMDB reader"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_cli_reads_the_released_data_categories(tiny_xl, tmp_path, capsys, case):
    config, make, res, overrides, source = CASES[case]
    root = make(str(tmp_path / "data"), res)
    out = cli.main(["--config", os.path.join(CONFIGS, config), "--device", "cpu",
                    "--results_dir", str(tmp_path / "results"), "--num_workers", "1",
                    "--max_steps", "1", "train.batchsize=2", f"data.root={root}", *overrides])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert source in capsys.readouterr().out
    with open(os.path.join(out["exp_dir"], "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1]
