"""The port's trainability gate (tools/torch_overfit_gate.py) against the
JAX one (tools/overfit_gate.py).

Its fixture LMDB equals the JAX ``build_fixture``'s byte for byte, its
config is the JAX ``CONFIG_TMPL``'s, and a 2-step run through the port's
Trainer and sampler on the CPU returns a complete verdict that does not
pass (twin of tests/test_overfit_gate.py::test_gate_wiring_two_steps).
The full 2000-step gate runs outside the tests (PERF.md records it).
"""

import os

import numpy as np
import pytest

from maskdit_tpu.utils import config as jax_config
from maskdit_tpu_torch.models import dit
from tools import overfit_gate as jax_gate
from tools import torch_overfit_gate as gate


def test_fixture_lmdb_equals_jax(tmp_path):
    root, targets = gate.build_fixture(str(tmp_path / "ours"), 8, 16, 4)
    jax_root, jax_targets = jax_gate.build_fixture(str(tmp_path / "theirs"), 8, 16, 4)
    np.testing.assert_array_equal(targets, jax_targets)
    assert os.path.relpath(root, tmp_path / "ours") == os.path.relpath(jax_root,
                                                                       tmp_path / "theirs")
    for r in (root, jax_root):
        assert os.listdir(os.path.join(r, "train")) == ["data.mdb"]
    with open(os.path.join(root, "train", "data.mdb"), "rb") as a, \
            open(os.path.join(jax_root, "train", "data.mdb"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("steps,mask_fn", [(2000, "cosine2"), (2, "constant")])
def test_config_equals_the_jax_template(steps, mask_fn):
    kw = dict(res=16, channels=4, k=8, batch=32, lr=2e-3, steps=steps, ema_decay=0.995,
              mask_ratio=0.5, mask_fn=mask_fn)
    want = jax_config.loads(jax_gate.CONFIG_TMPL.format(
        root="/data/x", log_every=max(1, steps // 30), **kw)).to_container()
    assert gate.gate_config("/data/x", **kw) == want


def test_gate_wiring_two_steps(tmp_path):
    before = (dict(dit.DIT_CONFIGS["DiT-S/2"]), dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH,
              dit.DECODER_NUM_HEADS)
    verdict = gate.run_gate(steps=2, out=str(tmp_path), k=4, batch=8, lr=1e-3,
                            num_sample_steps=2, mask_fn="constant", device="cpu")
    for key in ("steps", "loss_start", "loss_end", "nn_match", "on_target_mse",
                "off_target_mse", "mse_ratio", "passed"):
        assert key in verdict, key
    assert verdict["steps"] == 2
    assert np.isfinite(verdict["loss_end"]) and np.isfinite(verdict["on_target_mse"])
    assert "native LMDB reader" in verdict["reader"]
    # 2 steps from init cannot memorize: the gate must not pass vacuously
    assert verdict["passed"] is False
    # the tiny rebind is undone
    assert (dit.DIT_CONFIGS["DiT-S/2"], dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH,
            dit.DECODER_NUM_HEADS) == before
