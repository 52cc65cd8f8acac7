"""The port's evaluation metrics, dataset and FID / evaluator CLIs against
the JAX package's.

Inputs are made from a seed with numpy. The metric functions take the same
features on both sides: FID, IS and the statistics agree to 1e-9 relative
(fp64 on both sides; only sqrtm's and the sums' rounding differ).
Precision / recall take integer-valued features, whose squared distances
fp32 computes exactly on both sides, so that no distance lies on a radius
within rounding noise: the decisions must be equal. The FID CLI runs
``ref`` then ``calc`` on folders of small PNGs with random detector weights
given to both packages: statistics and FID within 1e-4 relative (the
detectors' fp32 features differ by ~1e-6, tests/test_torch_inception.py).
"""

import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from maskdit_tpu.data.datasets import ImageFolderDataset as JaxImageFolderDataset
from maskdit_tpu.evals import evaluator as jev
from maskdit_tpu.evals import fid as jfid
from maskdit_tpu.evals import inception as jinc
from maskdit_tpu_torch import evaluator as evaluator_cli
from maskdit_tpu_torch import fid as fid_cli
from maskdit_tpu_torch.data.datasets import ImageFolderDataset
from maskdit_tpu_torch.evals import evaluator as ev
from maskdit_tpu_torch.evals import fid as fid_lib
from maskdit_tpu_torch.utils.png import write_png
from maskdit_tpu_torch.utils.port import inception_state_dict_from_flax
from tests.test_torch_inception import random_jax_params

REL = 1e-9


def test_streaming_stats_and_fid_match_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(300, 32)).astype(np.float32)
    ref = rng.normal(size=(200, 32)) * 1.3 + 0.2
    ours, theirs = fid_lib.StreamingStats(32), jfid.StreamingStats(32)
    for chunk in np.array_split(feats, 7):
        ours.update(chunk)
        theirs.update(chunk)
    ours.merge_across_hosts()
    theirs.merge_across_hosts()
    (mu, sigma), (jmu, jsigma) = ours.finalize(), theirs.finalize()
    assert ours.count == theirs.count == 300
    np.testing.assert_allclose(mu, jmu, rtol=REL, atol=0)
    np.testing.assert_allclose(sigma, jsigma, rtol=REL, atol=1e-12)
    mu_r, sigma_r = ref.mean(0), np.cov(ref, rowvar=False)
    got = fid_lib.calculate_fid_from_inception_stats(mu, sigma, mu_r, sigma_r)
    want = jfid.calculate_fid_from_inception_stats(jmu, jsigma, mu_r, sigma_r)
    assert got == pytest.approx(want, rel=REL)
    assert ev.frechet_distance(feats, ref) == pytest.approx(jev.frechet_distance(feats, ref),
                                                            rel=REL)
    for a, b in zip(ev.feature_stats(feats), jev.feature_stats(feats)):
        np.testing.assert_allclose(a, b, rtol=REL, atol=1e-12)


def test_singular_product_takes_the_reference_evaluators_offset():
    """Where sqrtm of sigma_a @ sigma_b is not finite, the port adds 1e-6 to
    both diagonals first, as the reference evaluator does
    (evaluator.py:148-156); the JAX package takes the trace of the
    non-finite root as it is (here its off-diagonal inf drops out)."""
    import scipy.linalg

    mu = np.zeros(2)
    nilpotent, eye = np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2)
    assert not np.isfinite(scipy.linalg.sqrtm(nilpotent @ eye)).all()
    assert jev.frechet_distance_from_stats((mu, nilpotent), (mu, eye)) == 2.0
    with pytest.warns(UserWarning, match="singular product"):
        got = ev.frechet_distance_from_stats((mu, nilpotent), (mu, eye))
    offset = 1e-6 * eye
    want = jfid.calculate_fid_from_inception_stats(mu, nilpotent + offset, mu, eye + offset)
    assert np.isfinite(got) and got == pytest.approx(want, rel=REL)


def test_inception_score_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(700, 50)).astype(np.float32) * 3
    for split in (5000, 128):
        assert ev.inception_score(logits, split) == pytest.approx(
            jev.inception_score(logits, split), rel=REL)


@pytest.mark.parametrize("nhood", [1, 3])
def test_precision_recall_matches_jax(nhood):
    rng = np.random.default_rng(2 + nhood)
    ref = rng.integers(-4, 5, size=(90, 12)).astype(np.float32)
    gen = rng.integers(-4, 5, size=(70, 12)) + rng.integers(0, 2, size=(70, 12))
    gen = gen.astype(np.float32)
    got = ev.precision_recall(ref, gen, nhood, device="cpu")
    want = jev.precision_recall(ref, gen, nhood)
    assert got == want and 0 < got[0] < 1 and 0 < got[1] < 1, (got, want)
    ours = ev.ManifoldEstimator(ref, nhood, batch=32, device="cpu")
    theirs = jev.ManifoldEstimator(ref, nhood, batch=32)
    np.testing.assert_array_equal(ours.radii.numpy(), theirs.radii)
    np.testing.assert_array_equal(ours.evaluate(gen, batch=16), theirs.evaluate(gen, batch=16))


def test_evaluator_pads_ragged_batches_as_jax_does():
    calls = []

    def detector(images):
        calls.append(images.shape[0])
        flat = images.reshape(images.shape[0], -1).astype(np.float32)
        return {"pool": flat[:, :4], "spatial": flat[:, :3] * 2.0, "logits": flat[:, :5] - 1.0}

    imgs = np.random.default_rng(5).integers(0, 255, size=(11, 1, 4, 4), dtype=np.uint8)
    ours = ev.Evaluator(detector, batch=4, device="cpu")
    got = ours.features_from_batches([imgs[:6], imgs[6:]])
    want = jev.Evaluator(detector, batch=4).features_from_batches([imgs[:6], imgs[6:]])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert set(calls) == {4}
    metrics = ours.compute_all(imgs[:8], imgs[3:])
    assert set(metrics) == {"inception_score", "fid", "sfid", "precision", "recall"}


def _image_tree(root, rng) -> None:
    """Nested PNGs (RGB and gray), a JPEG and a file that is no image."""
    os.makedirs(os.path.join(root, "b", "c"))
    for i, name in enumerate(["z.png", "a.png", "b/x.png", "b/c/y.png", "b/w.png", "m.png"]):
        shape = (6, 5) if i == 3 else (6, 5, 3)
        write_png(os.path.join(root, name), rng.integers(0, 256, shape, dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)).save(
        os.path.join(root, "b", "q.jpg"))
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("not an image")


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_image_folder_dataset_matches_jax(tmp_path, source):
    root = str(tmp_path / "images")
    _image_tree(root, np.random.default_rng(6))
    path = root
    if source == "zip":
        path = str(tmp_path / "images.zip")
        with zipfile.ZipFile(path, "w") as zf:
            for base, _, files in os.walk(root):
                for f in files:
                    full = os.path.join(base, f)
                    zf.write(full, os.path.relpath(full, root))
    for kwargs in ({}, {"max_size": 4, "random_seed": 3}, {"max_size": 4, "random_seed": 4},
                   {"max_size": 100}):
        ours = ImageFolderDataset(path, **kwargs)
        theirs = JaxImageFolderDataset(path, label_dim=0, **kwargs)
        assert len(ours) == len(theirs) == min(7, kwargs.get("max_size", 7))
        for i in range(len(ours)):
            (a, la), (b, lb) = ours[i], theirs[i]
            assert a.dtype == np.uint8 and a.shape == b.shape and la.shape == lb.shape == (0,)
            np.testing.assert_array_equal(a, b)
        ours.close()
        theirs.close()


def test_fid_cli_ref_then_calc_matches_jax(tmp_path):
    params = random_jax_params(seed=8)
    detector_path = str(tmp_path / "pt_inception.pth")
    torch.save(inception_state_dict_from_flax(params), detector_path)
    rng = np.random.default_rng(9)
    data, images = str(tmp_path / "data"), str(tmp_path / "images")
    for folder in (data, images):
        os.makedirs(folder)
        for i in range(5):
            write_png(os.path.join(folder, f"{i:06d}.png"),
                      rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    common = ["--detector_path", detector_path, "--batch", "3", "--device", "cpu"]
    ours_stats = str(tmp_path / "ours.npz")
    assert fid_cli.main(["ref", "--data", data, "--dest", ours_stats, *common]) is None
    value = fid_cli.main(["calc", "--images", images, "--ref", ours_stats, "--num", "5",
                          *common])

    jax_detector = jinc.make_detector(jax.tree.map(jnp.asarray, params))
    theirs_stats = str(tmp_path / "theirs.npz")
    jfid.ref(data, theirs_stats, 3, jax_detector)
    with np.load(ours_stats) as a, np.load(theirs_stats) as b:
        for key in ("mu", "sigma"):
            err = np.abs(a[key] - b[key]).max() / np.abs(b[key]).max()
            assert err <= 1e-4, (key, err)
    want = jfid.calc(images, theirs_stats, 5, 0, 3, jax_detector)
    assert np.isfinite(value) and value == pytest.approx(want, rel=1e-4)
    with pytest.raises(ValueError, match="expected at least 6"):
        fid_cli.main(["calc", "--images", images, "--ref", ours_stats, "--num", "6", *common])


def test_evaluator_cli_prints_the_five_metrics(tmp_path, capsys, monkeypatch):
    """npz batches made by ``png_folder_to_npz`` (as the JAX one makes
    them): finite IS, FID, sFID and P&R in [0, 1]. The detector is a stand-in
    with 16 / 12 / 10 features (the InceptionV3 is held to the JAX one in
    tests/test_torch_inception.py and runs in the CLI on the card): sqrtm of
    a 2048 x 2048 product takes ~10 s on a CPU, and far longer on a loaded
    one."""
    built = []

    def small_detector(args):
        built.append(args.random_detector)
        proj = np.random.default_rng(0).normal(size=(3 * 12 * 12, 38)).astype(np.float32)

        def detect(images):
            f = images.reshape(len(images), -1).astype(np.float32) / 255 @ proj
            return {"pool": f[:, :16], "spatial": f[:, 16:28], "logits": f[:, 28:]}

        return detect

    monkeypatch.setattr(evaluator_cli, "build_detector", small_detector)
    rng = np.random.default_rng(10)
    batches = []
    for name in ("ref", "sample"):
        folder = str(tmp_path / name)
        os.makedirs(folder)
        for i in range(6):
            write_png(os.path.join(folder, f"{i:06d}.png"),
                      rng.integers(0, 256, (12, 12, 3), dtype=np.uint8))
        batches.append(str(tmp_path / f"{name}.npz"))
        ev.png_folder_to_npz(folder, batches[-1])
        jev.png_folder_to_npz(folder, str(tmp_path / f"{name}-jax.npz"))
        with np.load(batches[-1]) as a, np.load(str(tmp_path / f"{name}-jax.npz")) as b:
            np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
    metrics = evaluator_cli.main([*batches, "--random_detector", "--batch_size", "4",
                                  "--device", "cpu"])
    assert built == [True]
    printed = capsys.readouterr().out
    for line in ("Inception Score:", "FID:", "sFID:", "Precision:", "Recall:"):
        assert line in printed
    assert all(np.isfinite(v) for v in metrics.values()) and len(metrics) == 5
    assert 0 <= metrics["precision"] <= 1 and 0 <= metrics["recall"] <= 1


def test_chip_smoke_evaluates_the_released_256_config():
    """chip_smoke.py's eval config is configs/test/maskdit-256.yaml's model
    and eval sections (its phase points eval.ref_path elsewhere at run time)."""
    import chip_smoke
    from maskdit_tpu.utils import config as jax_config

    released = jax_config.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "test", "maskdit-256.yaml")).to_container()
    assert chip_smoke.EVAL_CONFIG_256 == {"model": released["model"], "eval": released["eval"]}
