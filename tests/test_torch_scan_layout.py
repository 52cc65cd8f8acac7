"""A JAX parameter tree in the ``scan_blocks`` layout, carried into the port.

The JAX model's ``scan_blocks`` (maskdit_tpu/models/dit.py:127-131,
:199-226) stacks the blocks into one ``lax.scan``: its tree holds
``blocks/scan/block`` with a leading depth axis where the unrolled one holds
``blocks_0`` .. ``blocks_{n-1}``. The port runs its blocks unrolled and
imports either layout (``utils/port.state_dict_from_flax`` through its
``unstack_scan_blocks``). At the tiny dims of the ``tiny_dit`` fixture, fp32
on the CPU:

  * the JAX ``stack_scan_blocks`` of a tree imports to the same state dict
    as the unrolled tree, exactly;
  * the port's model on that state dict against the JAX
    ``MaskDiT(scan_blocks=True)`` on the stacked tree, masked and unmasked,
    within the bound of tests/test_torch_masked_model.py;
  * the port's ``stack_scan_blocks`` / ``unstack_scan_blocks`` against the
    JAX functions: the same paths and arrays, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.utils import port as jax_port
from maskdit_tpu_torch.models import create_model
from maskdit_tpu_torch.models.masking import MaskInfo
from maskdit_tpu_torch.utils import port
from tests.test_torch_masked_model import ATOL, CIN, K, RES, inputs, mask_arrays
from tests.test_torch_model import patch_tiny_port

KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
          use_decoder=True, mae_loss_coef=0.1)


@pytest.fixture(scope="module")
def trees(tiny_dit_module):
    """The unrolled tree of random N(0, 0.05^2) parameters (seed 21), its
    JAX scan layout, the JAX scan model and the port's model."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **KW)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        mask_ratio=0.5, train=True))["params"]
    rng = np.random.default_rng(21)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32),
                          shapes)
    scan = jax_port.stack_scan_blocks(params)
    scan_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, scan_blocks=True,
                                  **KW)
    model = create_model("edm", dtype=torch.float32, **KW)
    model.load_state_dict(port.state_dict_from_flax(scan))
    yield params, scan, scan_model, model
    mp.undo()


def leaves(tree) -> list:
    return [(jax.tree_util.keystr(path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def test_scan_tree_imports_to_the_unrolled_state_dict(trees):
    params, scan, _, _ = trees
    assert "blocks" in scan["model"] and "blocks_0" not in scan["model"]
    got, want = port.state_dict_from_flax(scan), port.state_dict_from_flax(params)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("masked", [True, False], ids=["mask0.5", "unmasked"])
def test_port_model_matches_the_jax_scan_model(trees, masked):
    _, scan, scan_model, model = trees
    x, sigma, y = inputs(seed=22)
    kw, info = {}, None
    if masked:
        mask, ids_keep, ids_restore = mask_arrays(seed=23)
        kw = dict(mask_ratio=0.5, train=True, mask_info=JaxMaskInfo(
            jnp.asarray(mask), jnp.asarray(ids_keep), jnp.asarray(ids_restore)))
        info = MaskInfo(*(torch.from_numpy(a) for a in (mask, ids_keep, ids_restore)))
    theirs = scan_model.apply({"params": scan}, jnp.asarray(x), jnp.asarray(sigma),
                              jnp.asarray(y), **kw)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(sigma), torch.from_numpy(y),
                     **({"mask_ratio": 0.5, "mask_info": info, "train": True} if masked else {}))
    if masked:
        np.testing.assert_array_equal(ours["mask"].numpy(), np.asarray(theirs["mask"]))
    assert ours["x"].shape == (x.shape[0], CIN, RES, RES)
    np.testing.assert_allclose(ours["x"].numpy(), np.asarray(theirs["x"]), atol=ATOL)


def test_stack_and_unstack_match_the_jax_functions(trees):
    params, scan, _, _ = trees
    ours = port.stack_scan_blocks(params)
    assert [p for p, _ in leaves(ours)] == [p for p, _ in leaves(scan)]
    for (path, a), (_, b) in zip(leaves(ours), leaves(scan)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    back, want = port.unstack_scan_blocks(ours), jax_port.unstack_scan_blocks(scan)
    assert [p for p, _ in leaves(back)] == [p for p, _ in leaves(want)] == \
        [p for p, _ in leaves(params)]
    for (path, a), (_, b), (_, c) in zip(leaves(back), leaves(want), leaves(params)):
        assert np.array_equal(a, b) and np.array_equal(a, c), path
    assert port.unstack_scan_blocks(params)["model"].keys() == params["model"].keys()
