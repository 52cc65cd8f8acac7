"""The port's InceptionV3 (maskdit_tpu_torch/evals/inception.py) against the
JAX one.

Random JAX params (He-normal kernels, batch-norm statistics and affines
away from the identity, so that a swapped mean / var or scale / bias
shows) go into the port through ``inception_state_dict_from_flax``; both
detectors then see the same 2 uint8 images. fp32 on the CPU; the bound is
the max error relative to max|ref|, 1e-4 per output (~50 convolutions;
measured ~2e-6). ``preprocess`` is held to ``jax.image.resize`` at 32, 256
and 512 px, where a half-pixel convention would show at the edges: 1e-5 on
[-1, 1] values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.evals import inception as jinc
from maskdit_tpu_torch.evals import inception as inc
from maskdit_tpu_torch.utils.port import inception_state_dict_from_flax, load_inception

REL = 1e-4


def random_jax_params(seed: int = 0) -> dict:
    shapes = jax.eval_shape(lambda: jinc.InceptionV3().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 299, 299, 3))))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = np.prod(s.shape[:-1])
            return (rng.normal(size=s.shape) * np.sqrt(2 / fan_in)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.8, 1.2, size=s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def params():
    return random_jax_params()


def test_state_dict_is_the_pytorch_fid_layout(params, tmp_path):
    """The bridge inverts ``convert_inception`` exactly, and its keys are
    the port's (``num_batches_tracked`` included): a saved file loads
    strictly."""
    state = inception_state_dict_from_flax(params)
    back = jinc.convert_inception({k: v.numpy() for k, v in state.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): v
                         for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    a, b = flat(params), flat(back)
    assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert set(state) == set(inc.InceptionV3().state_dict())
    assert "Mixed_6d.branch1x1.bn.num_batches_tracked" in state
    path = str(tmp_path / "pt_inception-2015-12-05.pth")
    torch.save(state, path)
    loaded = load_inception(path)
    assert all(torch.equal(loaded[k], v) for k, v in state.items())
    torch.save({k: v for k, v in state.items() if k != "fc.bias"}, path)
    with pytest.raises(RuntimeError, match="fc.bias"):
        load_inception(path)


def test_features_match_jax(params):
    images = np.random.default_rng(1).integers(0, 256, size=(2, 3, 64, 64), dtype=np.uint8)
    ref = jinc.make_detector(jax.tree.map(jnp.asarray, params))(images)
    got = inc.make_detector(inception_state_dict_from_flax(params), "cpu")(images)
    assert set(got) == {"pool", "spatial", "logits"}
    for key, dim in (("pool", 2048), ("spatial", 2023), ("logits", 1008)):
        r = np.asarray(ref[key])
        assert got[key].shape == r.shape == (2, dim) and got[key].dtype == np.float32
        err = np.abs(got[key] - r).max() / np.abs(r).max()
        assert err <= REL, (key, err)


@pytest.mark.parametrize("size", [32, 256, 512])
def test_preprocess_matches_jax_resize(size):
    x = np.random.default_rng(size).integers(0, 256, size=(2, 3, size, size), dtype=np.uint8)
    ref = np.asarray(jinc.preprocess(jnp.asarray(x))).transpose(0, 3, 1, 2)
    got = inc.preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_random_state_dict_is_seeded():
    a, b, c = inc.random_state_dict(0), inc.random_state_dict(0), inc.random_state_dict(1)
    assert set(a) == set(inc.InceptionV3().state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc.weight"], c["fc.weight"])
