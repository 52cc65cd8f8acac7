"""tools/torch_validate_port.py against the pieces of tools/validate_port.py.

One reference-layout ``.pt`` file of a DiT-S/2 at the tiny dims of the
``tiny_dit`` fixture (depth 2, width 64, decoder 2 x 64 x 4), 8 x 8
latents, 16 classes, written by the JAX ``utils/port.export_maskdit``:
``ema`` N(0, 0.05^2) from a seed, ``model`` the same plus N(0, 0.01^2).
The twin's counts, its non-finite names (a NaN injected into a second
file), its EMA delta and its sigma table are held to what the JAX tool
computes with ``port.load_torch_state_dict``, ``convert_maskdit``,
``graft_params`` and ``create_model``. The sigma table takes injected x and
y (the two tools draw them from different generators): fp32 within 1e-5 of
max|ref| per column, bf16 within the whole-model bf16 bound (chip_smoke.py's
MODEL_REL_BOUND). Then the CLI once on the CPU with ``--sample``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.utils import port
from maskdit_tpu.utils.ckpt import graft_params as jax_graft_params
from tests.test_torch_model import patch_tiny_port

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import torch_validate_port as twin  # noqa: E402

RES, K = 8, 16
ARGS = ["--model_type", "DiT-S/2", "--image_size", str(RES), "--num_classes", str(K),
        "--use_decoder", "True", "--mae_loss_coef", "0.1", "--device", "cpu"]
BOUND = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
NAN_KEY = "model.blocks.1.attn.qkv.weight"


def _jax_model(dtype):
    return jax_create_model("edm", img_resolution=RES, img_channels=4, num_classes=K,
                            model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1,
                            dtype=dtype)


def _jax_init_shapes(model):
    return jax.eval_shape(
        lambda r: model.init({"params": r}, jnp.zeros((1, 4, RES, RES)), jnp.ones((1,)),
                             jnp.zeros((1, K))),
        jax.random.PRNGKey(0),
    )["params"]


def _save(path, ema_tree, model_tree):
    state = lambda tree: {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in port.export_maskdit(tree).items()}
    torch.save({"model": state(model_tree), "ema": state(ema_tree), "args": {}}, path)


@pytest.fixture(scope="module")
def files(tiny_dit_module, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    rng = np.random.default_rng(0)
    ema = jax.tree.map(lambda s: rng.normal(0.0, 0.05, s.shape).astype(np.float32),
                       _jax_init_shapes(_jax_model(jnp.float32)))
    raw = jax.tree.map(lambda a: a + rng.normal(0.0, 0.01, a.shape).astype(np.float32), ema)
    root = tmp_path_factory.mktemp("validate")
    clean = str(root / "ckpt.pt")
    _save(clean, ema, raw)
    broken = jax.tree.map(np.copy, raw)
    broken["model"]["blocks_1"]["attn"]["qkv"]["kernel"][0, 0] = np.nan
    nan = str(root / "nan.pt")
    _save(nan, ema, broken)
    yield clean, nan
    mp.undo()


def _twin_args(path, *extra):
    return twin.build_parser().parse_args(["--ckpt_path", path, *ARGS, *extra])


def _jax_pieces(path):
    """What tools/validate_port.py computes for sections 1 and 2."""
    trees, counts, non_finite = {}, {}, {}
    for key in ("ema", "model"):
        state = port.load_torch_state_dict(path, key=key)
        converted = port.convert_maskdit(state)
        counts[key] = (len([k for k in state if not k.endswith("pos_embed")]),
                       len(jax.tree.leaves(converted)))
        non_finite[key] = [jax.tree_util.keystr(p)
                           for p, leaf in jax.tree_util.tree_leaves_with_path(converted)
                           if not np.isfinite(np.asarray(leaf)).all()]
        trees[key] = converted
    delta = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(trees["ema"]), jax.tree.leaves(trees["model"])))
    return trees, counts, non_finite, delta


def test_coverage_and_ema_delta_match_jax(files):
    clean, nan = files
    args = _twin_args(clean)
    model = twin.build_model(args)
    trees, counts, _, delta = _jax_pieces(clean)
    cover = twin.coverage(model, twin.load_reference_states(clean))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                         _jax_init_shapes(_jax_model(jnp.bfloat16)))
    grafted = jax_graft_params(zeros, trees["ema"])
    for key in ("ema", "model"):
        c = cover[key]
        assert (c["n_src"], c["n_dst"]) == counts[key]
        assert c["n_dst"] == len(jax.tree.leaves(grafted)) == len(model.state_dict())
        assert c["non_finite"] == c["unused"] == c["unfilled"] == []
    ours = twin.ema_delta(twin.load_reference_states(clean))
    assert ours == pytest.approx(delta, rel=1e-6) and ours > 0

    _, _, non_finite, _ = _jax_pieces(nan)
    cover = twin.coverage(model, twin.load_reference_states(nan))
    assert cover["ema"]["non_finite"] == non_finite["ema"] == []
    assert cover["model"]["non_finite"] == [NAN_KEY]
    assert non_finite["model"] == ["['model']['blocks_1']['attn']['qkv']['kernel']"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sigma_table_matches_jax(files, dtype):
    clean, _ = files
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 4, RES, RES)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[np.array(twin.LABELS) % K]

    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmodel = _jax_model(jdtype)
    trees, _, _, _ = _jax_pieces(clean)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), _jax_init_shapes(jmodel))
    params = jax.tree.map(jnp.asarray, jax_graft_params(zeros, trees["ema"]))
    fwd = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, jnp.full((x.shape[0],), s),
                                               jnp.asarray(y))["x"])
    ref = []
    for sigma in twin.SIGMAS:
        d = np.asarray(fwd(params, jnp.asarray(x) * sigma, sigma), np.float64)
        c_skip = 0.25 / (sigma ** 2 + 0.25)
        ref.append((np.linalg.norm(d) / np.linalg.norm(x),
                    np.linalg.norm(d - c_skip * x.astype(np.float64) * sigma)))
    ref = np.array(ref)

    model = twin.build_model(_twin_args(clean), dtype)
    twin.graft_zeroed(model, twin.load_reference_states(clean)["ema"])
    table = twin.sigma_table(model, torch.from_numpy(x), torch.from_numpy(y))
    ours = np.array([(r["norm_ratio"], r["resid"]) for r in table])
    assert [r["sigma"] for r in table] == list(twin.SIGMAS)
    assert np.isfinite(ours).all() and ours[:, 1].max() > 0
    err = np.abs(ours - ref).max(axis=0) / np.abs(ref).max(axis=0)
    assert (err <= BOUND[dtype]).all(), err


def test_cli_samples_latents_on_cpu(files, tmp_path, capsys):
    clean, _ = files
    out = twin.main(["--ckpt_path", clean, *ARGS, "--sample", "--outdir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "[ema] " in printed and "EMA vs model: max|delta|=" in printed
    assert f"wrote samples to {tmp_path}" in printed
    assert len(out["table"]) == len(twin.SIGMAS) and out["ema_delta"] > 0
    z = np.load(tmp_path / "latents_000000.npy")
    assert z.shape == (8, 4, RES, RES) and np.isfinite(z).all()
