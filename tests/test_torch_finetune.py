"""The finetune phase in the port: configs/finetune/*.yaml, fp32, on the CPU.

The released finetune (scripts/finetune_latent512.sh) starts from a
reference ``.pt`` with ``--use_strict_load False``. Held here:

* the non-strict import: the port's ``Trainer(ckpt_path=...)`` gives the
  parameters the JAX package's ``load_reference_checkpoint(...,
  strict=False)`` + ``graft_params`` gives, exactly, on a file that lacks
  the mask token and holds an unknown key; the token keeps its
  initialisation; a transposed tensor raises in both;
* the flag: the released script's argument list parses and reaches the
  import;
* the three YAMLs through the train CLI at tiny dims (DiT-XL/2 shrunk to
  1 block of 2 heads of 72, decoder 1 block of 2 heads of 32), on a latent
  LMDB or WebDataset shards the test writes;
* one step at mask 0 and one at a cos4 bucket against the JAX train step
  on the same injected draws (``state.draw_step``'s z noise, dropout
  uniforms and mask; sigma and noise from the JAX loss's rng): loss within
  1e-5 relative, per-tensor gradient relative norm within 1e-4, parameters,
  EMA and moments within 1e-5;
* the per-step ratio and kept token count over a whole short cos4 schedule
  against the JAX trainer's ``mask_ratio_fn`` + ``bucket_ratio`` (and with
  ``pad_to_max``, its ``_mask_len_max`` and the padded count);
* the MFU of an unmasked finetune counts the step's own mask ratio;
* the 512-px finetune with ``model.use_flash=true`` (chip_smoke.py's
  ``[train-finetune512-flash]``): its config is the YAML's but for the flag,
  data.root and the cuts; the CLI routes every attention to the flash
  Function (2 forwards and 1 backward per layer and step); one fp32 step at
  mask 0 on the flash path against the JAX step on its Pallas kernels in
  interpret mode.
"""

import json
import os
import shlex
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models import masking as jax_masking
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu.ops import flash as jax_flash
from maskdit_tpu.train.loss import EDMLoss as JaxEDMLoss
from maskdit_tpu.train.schedules import bucket_ratio as jax_bucket_ratio
from maskdit_tpu.train.schedules import get_mask_ratio_fn as jax_mask_ratio_fn
from maskdit_tpu.train.state import make_optimizer as jax_make_optimizer
from maskdit_tpu.train.trainer import Trainer as JaxTrainer
from maskdit_tpu.utils import ckpt as jax_ckpt
from maskdit_tpu.utils.port import convert_maskdit
from maskdit_tpu_torch.data.datasets import write_latent_lmdb
from maskdit_tpu_torch.data.wds import write_wds_shards
from maskdit_tpu_torch.models import create_model, dit, layers, masking
from maskdit_tpu_torch.models.layers import DecoderLayer
from maskdit_tpu_torch.ops import flash
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.state import (
    create_train_state,
    draw_step,
    make_optimizer,
    make_train_step,
)
from maskdit_tpu_torch.train.trainer import Trainer
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from maskdit_tpu_torch.utils.profiling import maskdit_train_flops_per_image
from tests.test_torch_loss import jax_draws
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_trainer import SMOKE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FINETUNE = {name: os.path.join(ROOT, "configs", "finetune", f"imagenet{name}.yaml")
            for name in ("256-latent-const", "256-latent-cos", "512-latent")}
SCRIPT = os.path.join(ROOT, "scripts", "finetune_latent512.sh")
LOSS_REL, GRAD_REL, STATE_REL = 1e-5, 1e-4, 1e-5
CIN = 4


@pytest.fixture
def tiny_xl(monkeypatch):
    """DiT-XL/2, which the finetune YAMLs name, at 1 block of 2 heads of 72
    (the released head dim) and a decoder of 1 block of 2 heads of 32."""
    monkeypatch.setitem(dit.DIT_CONFIGS, "DiT-XL/2",
                        dict(depth=1, hidden_size=144, patch_size=2, num_heads=2))
    monkeypatch.setattr(dit, "DECODER_HIDDEN_SIZE", 64)
    monkeypatch.setattr(dit, "DECODER_DEPTH", 1)
    monkeypatch.setattr(dit, "DECODER_NUM_HEADS", 2)


@pytest.fixture
def encoder_widths():
    """The token count the encoder hands the decoder in each forward: the
    kept tokens (packed), all of them (unmasked) or len_max (padded)."""
    widths = []
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda mod, args: widths.append(args[0].shape[1]) if isinstance(mod, DecoderLayer)
        else None)
    yield widths
    handle.remove()


def reference_file(path, model, drop=("model.mask_token",), extra=True, transpose=None):
    """A reference-layout ``.pt`` of ``model``'s state: ``model`` and an
    ``ema`` 0.01 off it, without the keys ``drop``, with an unknown key and
    the recomputed pos-embed table, and with ``transpose``'s tensor
    transposed."""
    state = {k: v.detach().clone() for k, v in model.state_dict().items() if k not in drop}
    g = torch.Generator().manual_seed(1)
    ema = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in state.items()}
    for sd in (state, ema):
        if extra:
            sd["model.unknown_head.weight"] = torch.ones(3, 5)
            sd["model.pos_embed"] = model.model.pos_embed.clone()
        if transpose:
            sd[transpose] = sd[transpose].t().contiguous()
    torch.save({"model": state, "ema": ema, "args": {"note": "test"}}, path)
    return {"model": state, "ema": ema}


def smoke_cfg(*overrides):
    return cli.apply_overrides(cli.load_config(SMOKE), ["train.fp32=true", *overrides])


def test_reference_import_matches_jax_graft(tmp_path, monkeypatch, capsys):
    """R1: the port's import of a file that lacks the mask token and holds
    an unknown key equals the JAX package's strict=False import grafted onto
    the same fresh parameters, exactly; the token is the fresh
    initialisation of the same seed, and the import names it."""
    patch_tiny_port(monkeypatch)
    cfg = smoke_cfg()
    fresh = Trainer(cfg, results_dir=str(tmp_path / "fresh"), device="cpu", num_workers=1)
    path = str(tmp_path / "ref.pt")
    written = reference_file(path, fresh.model)
    capsys.readouterr()
    trainer = Trainer(cfg, results_dir=str(tmp_path / "ft"), device="cpu", num_workers=1,
                      ckpt_path=path)
    printed = capsys.readouterr().out
    assert "kept at their initialisation: ['model.model.mask_token', 'ema.model.mask_token']" \
        in printed
    init = {k: v.numpy() for k, v in fresh.state.named(fresh.state.params).items()}
    for entry, flat, use_ema in (("model", trainer.state.params, False),
                                 ("ema", trainer.state.ema, True)):
        loaded = jax_ckpt.load_reference_checkpoint(path, use_ema=use_ema, strict=False)
        want = state_dict_from_flax(jax_ckpt.graft_params(convert_maskdit(init), loaded))
        got = trainer.state.named(flat)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (entry, k)
            if k != "model.mask_token":
                assert torch.equal(got[k], written[entry][k]), (entry, k)
        # the token the file lacks is the fresh one of the same seed
        assert torch.equal(got["model.mask_token"], torch.from_numpy(init["model.mask_token"]))
    assert trainer.start_step == 0


def test_reference_import_shape_mismatch_raises_in_both(tmp_path, monkeypatch):
    """R1: a transposed tensor (same element count) raises ValueError naming
    the key in the port, where the parent reshaped it silently, and in the
    JAX graft."""
    patch_tiny_port(monkeypatch)
    cfg = smoke_cfg()
    fresh = Trainer(cfg, results_dir=str(tmp_path / "fresh"), device="cpu", num_workers=1)
    key = "model.blocks.0.mlp.fc1.weight"
    assert fresh.model.state_dict()[key].dim() == 2
    path = str(tmp_path / "transposed.pt")
    reference_file(path, fresh.model, drop=(), extra=False, transpose=key)
    with pytest.raises(ValueError, match=f"shape mismatch at {key}"):
        Trainer(cfg, results_dir=str(tmp_path / "ft"), device="cpu", num_workers=1,
                ckpt_path=path)
    init = {k: v.numpy() for k, v in fresh.state.named(fresh.state.params).items()}
    loaded = jax_ckpt.load_reference_checkpoint(path, use_ema=False, strict=False)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_ckpt.graft_params(convert_maskdit(init), loaded)


def test_resume_stays_strict(tmp_path, monkeypatch):
    """The port's own resume checkpoints load strictly: a missing key is a
    fault there (KeyError), a transposed one a ValueError."""
    patch_tiny_port(monkeypatch)
    trainer = Trainer(smoke_cfg(), results_dir=str(tmp_path), device="cpu", num_workers=1)
    ckpt = trainer.state.checkpoint()
    del ckpt["model"]["model.mask_token"]
    with pytest.raises(KeyError, match="mask_token"):
        trainer.state.load(ckpt)
    ckpt = trainer.state.checkpoint()
    ckpt["opt"]["mu"]["model.blocks.0.mlp.fc1.weight"] = \
        ckpt["opt"]["mu"]["model.blocks.0.mlp.fc1.weight"].t()
    with pytest.raises(ValueError, match="fc1.weight"):
        trainer.state.load(ckpt)


def script_args():
    """The train.py arguments of scripts/finetune_latent512.sh."""
    text = open(SCRIPT).read().replace("\\\n", " ")
    (line,) = [x for x in text.splitlines() if "train.py" in x]
    words = shlex.split(line)
    return words[words.index("train.py") + 1:]


def write_data(tmp_path, name, n=4):
    """A latent LMDB (256-px configs) or WebDataset shards (512) of ``n``
    records of moments at the config's latent size; returns data.root."""
    res = 64 if name.startswith("512") else 32
    rng = np.random.default_rng(2)
    moments = rng.normal(size=(n, 2 * CIN, res, res)).astype(np.float32)
    root = str(tmp_path / f"data-{name}")
    if res == 64:
        write_wds_shards([(f"{i:07d}", moments[i], i) for i in range(n)], root, maxcount=2)
    else:
        write_latent_lmdb(os.path.join(root, "train"), moments, np.arange(n) % 7)
    return root


def test_use_strict_load_parses_and_the_released_script_reaches_the_import(
        tiny_xl, tmp_path, capsys, encoder_widths):
    """R2: the port's CLI takes --use_strict_load as the JAX CLI does
    (train.py:116: str2bool, default True); the released script's argument
    list, its paths swapped for the test's, parses, imports the file
    non-strictly and trains."""
    parser = cli.build_parser()
    assert parser.parse_args(["--config", "x"]).use_strict_load is True
    assert parser.parse_args(["--config", "x", "--use_strict_load", "False"]).use_strict_load is False
    args = script_args()
    assert args == ["--config", "configs/finetune/imagenet512-latent.yaml", "--ckpt_path",
                    "checkpoints/1050000.pt", "--use_strict_load", "False"]
    path = str(tmp_path / "1050000.pt")
    reference_file(path, create_model("edm", img_resolution=64, img_channels=CIN,
                                      num_classes=1000, model_type="DiT-XL/2", use_decoder=True,
                                      mae_loss_coef=0.1))
    swap = {"configs/finetune/imagenet512-latent.yaml": FINETUNE["512-latent"],
            "checkpoints/1050000.pt": path}
    out = cli.main([swap.get(a, a) for a in args] + [
        "--device", "cpu", "--num_workers", "1", "--max_steps", "1",
        "--results_dir", str(tmp_path / "results"), "train.batchsize=2",
        f"data.root={write_data(tmp_path, '512')}"])
    assert f"imported reference checkpoint {path}" in capsys.readouterr().out
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert encoder_widths == [1024]


@pytest.mark.parametrize("name", list(FINETUNE))
def test_finetune_config_trains_through_the_cli(tiny_xl, tmp_path, capsys, encoder_widths, name):
    """Each released finetune YAML, as released but for data.root, the
    batch and the model's depth and width: one fp32 step from an imported
    reference file (no mask token in it). The encoder runs unmasked (L256,
    L1024) on the const and 512 configs and at the cos4 schedule's first
    bucket (128 of 256) on the cos config."""
    cfg = cli.load_config(FINETUNE[name])
    assert cfg["train"]["fp32"] is True
    res = cfg["model"]["in_size"]
    model = create_model("edm", img_resolution=res, img_channels=CIN, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1)
    path = str(tmp_path / "ref.pt")
    reference_file(path, model)
    out = cli.main(["--config", FINETUNE[name], "--ckpt_path", path, "--use_strict_load",
                    "False", "--device", "cpu", "--num_workers", "1", "--max_steps", "1",
                    "--results_dir", str(tmp_path / "results"), "train.batchsize=2",
                    f"data.root={write_data(tmp_path, name)}"])
    printed = capsys.readouterr().out
    assert "kept at their initialisation: ['model.model.mask_token', 'ema.model.mask_token']" \
        in printed
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert out["state"].params.dtype == torch.float32
    assert out["state"].model.model.dtype == torch.float32
    full = (res // 2) ** 2
    assert encoder_widths == [full // 2 if name == "256-latent-cos" else full]


# ---------------------------------------------------------------------------
# one step against the JAX step: mask 0 and a cos4 bucket
# ---------------------------------------------------------------------------

RES, K, N = 16, 6, 4
L = (RES // 2) ** 2


@pytest.fixture(scope="module")
def pair(tiny_dit_module):
    """The tiny DiT-S/2 (decoder, MAE 0.1) in both packages, fp32, with the
    same random weights, at 16 x 16 latents (L 64, so cos4 has buckets)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    kw = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
              use_decoder=True, mae_loss_coef=0.1)
    jax_model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **kw)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        mask_ratio=0.5, train=True))["params"]
    rng = np.random.default_rng(90)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32),
                          shapes)
    yield jax_model, params, kw
    mp.undo()


def jax_step(jax_model, params, x, y, info, ratio, rng, lr, decay):
    """The JAX step on injected z and dropout (the trainer's step body) and
    mask: loss, gradients, and the fused Adam + EMA update from a fresh
    optimizer state."""
    def loss_fn(p):
        def net_apply(xin, sigma, lab, m_ratio, feat, rngs, mask_info=None):
            return jax_model.apply({"params": p}, xin, sigma, lab, mask_ratio=m_ratio,
                                   mask_info=info, train=True)

        vec, _ = JaxEDMLoss()(net_apply, jnp.asarray(x), rng, labels=jnp.asarray(y),
                              mask_ratio=ratio, mae_loss_coef=0.1, patch_size=2)
        return vec.mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    optimizer = jax_make_optimizer(lr, N, fused=True)
    new_p, new_opt, new_ema = optimizer.update_with_ema(
        grads, optimizer.init(params), params, params, ema_decay=decay)
    return float(loss), grads, new_p, new_opt[0], new_ema


def cos4_bucket_at(progress):
    """The JAX trainer's bucketed ratio of the cos4 finetune (mask 0.5 to 0)
    at ``progress``, at L 64."""
    return jax_bucket_ratio(float(jax_mask_ratio_fn("cos4", 0.5, 0)(progress)), L)


def assert_step_matches_jax(jax_model, params, kw, ratio, res):
    """One port step (fresh Adam, EMA) at ``ratio`` on ``res`` x ``res``
    latents against ``jax_step`` on the same injected draws: loss,
    gradients, parameters, EMA and moments within LOSS_REL, GRAD_REL,
    STATE_REL. Returns the draws."""
    lr, decay = 5e-5, 0.9999
    model = create_model("edm", dtype=torch.float32, **kw)
    model.load_state_dict(state_dict_from_flax(params))
    opt = make_optimizer(lr, N)
    state = create_train_state(model, opt)
    rng_np = np.random.default_rng(91)
    moments = rng_np.normal(size=(N, 2 * CIN, res, res)).astype(np.float32)
    labels = np.eye(K, dtype=np.float32)[rng_np.integers(0, K, N)]
    gen = torch.Generator().manual_seed(92)
    draws = draw_step(gen, N, (CIN, res, res), torch.device("cpu"), grad_accum=1, reparam=True,
                      dropout=True, mask_ratio=ratio, patch_size=2, loss_fn=EDMLoss())
    assert (draws.mask_info is None) == (ratio == 0.0)
    rng = jax.random.PRNGKey(93)
    sigma, noise = jax_draws(rng, (N, CIN, res, res))
    draws = draws._replace(sigma=torch.from_numpy(sigma), noise=torch.from_numpy(noise))
    step = make_train_step(opt, mask_ratio=ratio, mae_loss_coef=0.1, ema_decay=decay)
    metrics = step(state, {"x": torch.from_numpy(moments), "y": torch.from_numpy(labels)},
                   draws=draws)

    mean, logvar = np.split(moments, 2, axis=1)
    x = 0.18215 * (mean + np.exp(0.5 * np.clip(logvar, -30.0, 20.0)) * draws.z_noise.numpy())
    y = labels * (draws.drop_u.numpy() >= 0.1).astype(np.float32)
    info = None if draws.mask_info is None else JaxMaskInfo(
        *(jnp.asarray(t.numpy().astype(np.int32 if t.dtype == torch.int64 else np.float32))
          for t in draws.mask_info[:3]))
    loss, grads, new_p, adam, new_ema = jax_step(jax_model, params, x, y, info, ratio, rng, lr,
                                                 decay)
    assert abs(float(metrics["loss"]) - loss) <= LOSS_REL * abs(loss)
    rel = lambda a, b: float((a - b).norm() / b.norm().clamp_min(1e-30))
    for k, v in state_dict_from_flax(grads).items():
        assert rel(state.named(state.grads)[k], v) <= GRAD_REL, k
    for flat, tree in ((state.params, new_p), (state.ema, new_ema),
                       (state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        for k, v in state_dict_from_flax(tree).items():
            if v.norm() > 0:
                assert rel(state.named(flat)[k], v) <= STATE_REL, k
    return draws


@pytest.mark.parametrize("ratio", [0.0, cos4_bucket_at(0.5)], ids=["mask0", "cos4_bucket"])
def test_finetune_step_matches_jax(pair, ratio):
    jax_model, params, kw = pair
    assert ratio in (0.0, 0.25)
    draws = assert_step_matches_jax(jax_model, params, kw, ratio, RES)
    if ratio > 0:  # the encoder saw the bucket's kept tokens
        assert draws.mask_info.ids_keep.shape[1] == jax_masking.len_keep_for(L, ratio) == 48


# ---------------------------------------------------------------------------
# the cos4 schedule over a run, and the MFU of an unmasked finetune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad_to_max", [False, True], ids=["bucketed", "pad_to_max"])
def test_cos4_schedule_matches_the_jax_trainer(tiny_xl, tmp_path, encoder_widths, monkeypatch,
                                               pad_to_max):
    """imagenet256-latent-cos.yaml over a whole schedule of 8 steps: each
    step's ratio (the trainer's log) and kept token count (what reached the
    decoder, or with pad_to_max the padded mask's valid count) equal the
    JAX trainer's, from its mask_ratio_fn and bucket_ratio (trainer.py:306,
    365), or its _mask_len_max and the JAX loss's padded count."""
    steps = 8
    kept = []
    if pad_to_max:
        real = masking.scatter_tokens_padded
        monkeypatch.setattr(masking, "scatter_tokens_padded",
                            lambda x, r, t, n, **kw: kept.append(int(n)) or real(x, r, t, n, **kw))
    cfg = cli.apply_overrides(cli.load_config(FINETUNE["256-latent-cos"]), [
        "train.batchsize=2", f"train.max_num_steps={steps}", "log.log_every=1",
        f"data.root={write_data(tmp_path, '256-latent-cos')}", f"train.pad_to_max={pad_to_max}"])
    trainer = Trainer(cfg, results_dir=str(tmp_path / "r"), device="cpu", num_workers=1)
    assert trainer.train() == steps
    m = cfg["model"]
    fn = jax_mask_ratio_fn(m["mask_ratio_fn"], m["mask_ratio"], m["mask_ratio_min"])
    seq_len = 256
    ratios = [float(fn(s / steps)) for s in range(steps)]
    assert [r["mask_ratio"] for r in trainer.history] == pytest.approx(ratios, rel=1e-12)
    if pad_to_max:
        len_max = JaxTrainer._mask_len_max(types.SimpleNamespace(mask_ratio_fn=fn,
                                                                 seq_len=seq_len))
        assert encoder_widths == [len_max] * steps and len_max == seq_len
        assert kept == [int(jnp.floor(seq_len * (1.0 - jnp.asarray(r, jnp.float32))))
                        for r in ratios]
    else:
        want = [jax_masking.len_keep_for(seq_len, jax_bucket_ratio(r, seq_len)) for r in ratios]
        assert encoder_widths == want
        assert len(set(want)) >= 4  # the schedule crossed several buckets
    assert np.isfinite([x for r in trainer.history for x in r["losses"]]).all()


def test_unmasked_finetune_mfu_counts_mask_zero(tiny_xl, tmp_path):
    """The trainer's MFU of the const finetune counts the step's mask ratio,
    0: the FLOPs of the unmasked encoder."""
    cfg = cli.apply_overrides(cli.load_config(FINETUNE["256-latent-const"]), [
        "train.batchsize=2", "log.log_every=1",
        f"data.root={write_data(tmp_path, '256-latent-const')}"])
    trainer = Trainer(cfg, results_dir=str(tmp_path / "r"), device="cpu", num_workers=1,
                      max_steps_override=1)
    trainer.peak_tflops = 1.0
    trainer.train()
    (record,) = trainer.history
    flops = maskdit_train_flops_per_image("DiT-XL/2", 32, 0.0, True)
    assert flops > maskdit_train_flops_per_image("DiT-XL/2", 32, 0.5, True)
    assert record["mask_ratio"] == 0.0
    assert record["mfu"] == pytest.approx(record["images_per_sec"] * flops / 1e12, rel=1e-12)


def test_route_at_the_cos4_buckets_against_the_jax_choice():
    """XL/2's encoder (16 heads of 72) at every kept count a cos4 finetune
    from mask 0.5 to 0 steps through at 256 px (buckets of 16 tokens, 128 to
    256), with a backward. Where the JAX package runs its whole-row kernels
    (L 128, 256) the port runs its whole-row kernels too; at the buckets in
    between, which are not a multiple of 128, the JAX package runs its plain
    attention and the port its kernels (whole-row to 224, blocked at 240),
    which compute the same function (ROADMAP C4)."""
    from tests.test_torch_512 import jax_choice

    got = {l: (layers.attention_route(16, l, 72, True), jax_choice(16, l, 72))
           for l in range(128, 257, 16)}
    assert got == {128: ("packed", "packed"), **{l: ("packed", "plain")
                                                 for l in range(144, 225, 16)},
                   240: ("big", "plain"), 256: ("packed", "packed")}
    # the decoder at all 256 tokens (16 heads of 32): the whole-row kernels
    assert layers.attention_route(16, 256, 32, True) == jax_choice(16, 256, 32) == "packed"


# ---------------------------------------------------------------------------
# the 512-px finetune with model.use_flash (chip_smoke's finetune512-flash)
# ---------------------------------------------------------------------------

def test_chip_smoke_finetune512_flash_is_the_released_config():
    """chip_smoke.py's [train-finetune512-flash] runs
    configs/finetune/imagenet512-latent.yaml as [train-finetune512] does
    (its data.root and cuts) with FINETUNE_FLASH_OVERRIDES, which sets
    model.use_flash, a key the YAML leaves unset, to true; nothing else
    differs."""
    config, cuts = chip_smoke.FINETUNE_CONFIGS["512-latent"]
    flashed = cli.apply_overrides(json.loads(json.dumps(config)),
                                  chip_smoke.FINETUNE_FLASH_OVERRIDES)
    released = cli.load_config(FINETUNE["512-latent"])
    assert "use_flash" not in released["model"] and flashed["model"]["use_flash"] is True
    assert set(flashed["model"]) == set(released["model"]) | {"use_flash"}
    assert set(flashed["train"]) == set(released["train"])
    for section in ("model", "train"):
        for key, value in released[section].items():
            if f"{section}.{key}" not in cuts:
                assert flashed[section][key] == value, f"{section}.{key}"
    for path, (was, now) in cuts.items():
        section, key = path.split(".")
        assert released[section][key] == was and flashed[section][key] == now, path
    assert flashed["data"] == {**released["data"], "root": chip_smoke.TRAIN_DATA_ROOT_512}
    assert flashed["train"]["fp32"] is True


def test_finetune512_with_use_flash_trains_through_the_cli(tiny_xl, tmp_path, encoder_widths,
                                                          monkeypatch):
    """The 512-px finetune YAML through the train CLI with
    ``model.use_flash=true``, as released otherwise (the import of a
    reference file without the mask token), at tiny widths: every encoder
    and decoder block routes to 'flash' at L 1024 and runs the flash
    Function's plain versions on the CPU, the forward twice (the
    checkpoint's recompute) and the backward once per step."""
    routes, calls = [], {"fwd": 0, "bwd": 0}
    real_route = layers.attention_route

    def route(*args, **kw):
        routes.append(real_route(*args, **kw))
        return routes[-1]

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(layers, "attention_route", route)
    monkeypatch.setattr(flash, "flash_fwd_reference", counting(flash.flash_fwd_reference, "fwd"))
    monkeypatch.setattr(flash, "flash_bwd_reference", counting(flash.flash_bwd_reference, "bwd"))
    model = create_model("edm", img_resolution=64, img_channels=CIN, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1)
    path = str(tmp_path / "ref.pt")
    reference_file(path, model)
    out = cli.main(["--config", FINETUNE["512-latent"], "--ckpt_path", path, "--use_strict_load",
                    "False", "--device", "cpu", "--num_workers", "1", "--max_steps", "1",
                    "--results_dir", str(tmp_path / "results"), "train.batchsize=2",
                    f"data.root={write_data(tmp_path, '512-latent')}",
                    *chip_smoke.FINETUNE_FLASH_OVERRIDES])
    assert out["step"] == 1 and np.isfinite(out["history"][0]["losses"]).all()
    assert out["state"].params.dtype == torch.float32
    attns = [m for m in out["state"].model.modules() if isinstance(m, layers.Attention)]
    assert len(attns) == 2 and all(a.use_flash is True for a in attns)
    assert routes == ["flash", "flash"]
    assert calls == {"fwd": 4, "bwd": 2}
    assert encoder_widths == [1024]


@pytest.fixture(scope="module")
def flash_pair(tiny_dit_module):
    """``pair``'s tiny DiT-S/2 with ``use_flash=True`` in both packages, at
    32 x 32 latents (L 256 unmasked: in the flash kernels' window)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    kw = dict(img_resolution=2 * RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
              use_decoder=True, mae_loss_coef=0.1, use_flash=True)
    jax_model = jax_create_model("edm", dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: jax_model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, 2 * RES, 2 * RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        mask_ratio=0.5, train=True))["params"]
    rng = np.random.default_rng(94)
    params = jax.tree.map(lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32),
                          shapes)
    yield jax_model, params, kw
    mp.undo()


def test_finetune_flash_step_matches_jax(flash_pair, monkeypatch):
    """One fp32 finetune step at mask 0 with ``use_flash`` (every attention
    on the flash Function: the port's plain versions on the CPU, the JAX
    ``flash_mha`` on its Pallas kernels in the interpreter,
    ``MASKDIT_PALLAS_INTERPRET=1``) against the JAX step, within the bounds
    of ``test_finetune_step_matches_jax``."""
    monkeypatch.setenv("MASKDIT_PALLAS_INTERPRET", "1")
    calls = {"fwd": 0, "jax": 0}

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(flash, "flash_fwd_reference", counting(flash.flash_fwd_reference, "fwd"))
    monkeypatch.setattr(jax_flash, "flash_mha", counting(jax_flash.flash_mha, "jax"))
    jax_model, params, kw = flash_pair
    assert layers.attention_route(4, 4 * RES * RES, 16, True, True) == "flash"
    assert_step_matches_jax(jax_model, params, kw, 0.0, 2 * RES)
    # 2 encoder + 2 decoder blocks: the port's forward twice each (the
    # checkpoint's recompute), the JAX flash_mha traced once each
    assert calls == {"fwd": 2 * 4, "jax": 4}
