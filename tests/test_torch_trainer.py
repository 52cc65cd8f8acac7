"""The port's training CLI end to end on the CPU, at the tiny dims.

``python -m maskdit_tpu_torch.train``'s ``main`` with
configs/train/synthetic-smoke.yaml (DiT-S/2 shrunk as ``tiny_dit`` shrinks
it): the log line, the checkpoints, resume, and the save on SIGTERM. Also
that chip_smoke.py trains on the released 256-px config, cut only where it
says so.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from maskdit_tpu.utils import config as config_lib
from maskdit_tpu_torch.train import cli
from maskdit_tpu_torch.train.trainer import Trainer
from maskdit_tpu_torch.utils.ckpt import CheckpointManager
from tests.test_torch_model import patch_tiny_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "train", "synthetic-smoke.yaml")
RELEASED = os.path.join(ROOT, "configs", "train", "imagenet256-latent.yaml")
ARGS = ["--config", SMOKE, "--device", "cpu", "--num_workers", "1",
        "log.log_every=1", "log.ckpt_every=2"]


@pytest.fixture
def tiny_port(monkeypatch):
    patch_tiny_port(monkeypatch)


def _exp_dir(results: str) -> str:
    (name,) = os.listdir(results)
    return os.path.join(results, name)


def _assert_restored(trainer: Trainer, ckpt: dict) -> None:
    state = trainer.state
    assert state.step == ckpt["step"] and state.opt_state.count == ckpt["opt"]["count"]
    for flat, saved in ((state.params, ckpt["model"]), (state.ema, ckpt["ema"]),
                        (state.opt_state.mu, ckpt["opt"]["mu"]),
                        (state.opt_state.nu, ckpt["opt"]["nu"])):
        named = state.named(flat)
        assert sorted(named) == sorted(saved)
        for k, v in saved.items():
            torch.testing.assert_close(named[k], v, rtol=0, atol=0)


def test_cli_trains_logs_saves_and_resumes(tiny_port, tmp_path, capsys):
    results = str(tmp_path / "results")
    out = cli.main([*ARGS, "--results_dir", results, "--max_steps", "3"])
    printed = capsys.readouterr().out
    assert out["step"] == 3 and [r["step"] for r in out["history"]] == [1, 2, 3]
    for step in (1, 2, 3):
        assert f"(step={step:07d}) loss=" in printed
    assert "mfu=n/a" in printed and "mem_peak=n/a" in printed  # no card
    assert all(torch.isfinite(torch.tensor(r["losses"])).all() for r in out["history"])
    # the rampup schedule (1 kimg at batch 8) is logged after each step
    assert [r["lr"] for r in out["history"]] == pytest.approx([1e-4 * 8 * s / 1000 for s in (1, 2, 3)])
    exp_dir = out["exp_dir"]
    assert exp_dir == _exp_dir(results)
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    assert "(step=0000003)" in open(os.path.join(exp_dir, "log.txt")).read()

    mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
    assert mgr.all_steps() == [2, 3]  # every 2 steps, and the last
    ckpt = mgr.restore()
    assert set(ckpt) == {"model", "ema", "opt", "step"} and ckpt["step"] == 3
    assert ckpt["opt"]["count"] == 3 and set(ckpt["opt"]["mu"]) == set(ckpt["model"])

    # a trainer on the same directory resumes from the newest checkpoint
    cfg = cli.apply_overrides(cli.load_config(SMOKE), ARGS[-2:])
    _assert_restored(Trainer(cfg, results_dir=results, device="cpu", num_workers=1), ckpt)
    out = cli.main([*ARGS, "--results_dir", results, "--max_steps", "2"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert out["step"] == 5 and [r["step"] for r in out["history"]] == [4, 5]
    assert mgr.all_steps() == [2, 3, 4, 5]


def test_sigterm_saves_and_stops(tiny_port, tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.fail("signal handlers can only be installed from the main thread")
    cfg = cli.apply_overrides(cli.load_config(SMOKE), ["log.log_every=5", "log.ckpt_every=100"])
    trainer = Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1,
                      max_steps_override=10)
    real = trainer._step_for_ratio
    taken = []

    def step_then_signal(ratio):
        step = real(ratio)

        def run(*args):
            metrics = step(*args)
            taken.append(1)
            if len(taken) == 2:
                signal.raise_signal(signal.SIGTERM)
            return metrics

        return run

    trainer._step_for_ratio = step_then_signal
    before = signal.getsignal(signal.SIGTERM)
    assert trainer.train() == 2  # finished the step in flight, then stopped
    assert signal.getsignal(signal.SIGTERM) is before  # the handler is restored
    assert trainer.ckpt_mgr.all_steps() == [2]
    _assert_restored(trainer, trainer.ckpt_mgr.restore())


def test_json_config_and_overrides(tmp_path):
    cfg = cli.load_config(SMOKE)
    path = tmp_path / "smoke.json"
    path.write_text(json.dumps(cfg))
    assert cli.load_config(str(path)) == cfg
    cli.apply_overrides(cfg, ["train.lr=0.5", "model.use_decoder=false",
                              "data.root=None", "log.tag=x-y"])
    assert cfg["train"]["lr"] == 0.5 and cfg["model"]["use_decoder"] is False
    assert cfg["data"]["root"] is None and cfg["log"]["tag"] == "x-y"
    cli.validate(cfg)
    del cfg["train"]["lr"]
    with pytest.raises(KeyError, match="train.lr"):
        cli.validate(cfg)


@pytest.mark.parametrize("override,why", [
    ("train.pad_to_max=true", "kv_valid"),
    ("train.accum_unroll=2", "scheduling knob"),
    ("train.peel_last_micro=true", "scheduling knob"),
], ids=["pad_to_max", "accum_unroll", "peel_last_micro"])
def test_unported_options_raise(tiny_port, tmp_path, override, why):
    """The train keys the port does not implement raise with their reason
    (the ported ones build a Trainer:
    tests/test_torch_train_options.py::test_ported_train_options_build_a_trainer)."""
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [override])
    with pytest.raises(NotImplementedError, match=why):
        Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1)


@pytest.mark.parametrize("override,error,default", [
    ("model.pad_cls_token=true", NotImplementedError, "model.pad_cls_token=false"),
    ("model.ext_feature_dim=16", NotImplementedError, "model.ext_feature_dim=0"),
    ("data.streaming=true", ValueError, "data.streaming=false"),
], ids=["pad_cls_token", "ext_feature_dim", "streaming"])
def test_config_keys_the_port_would_ignore_raise(tiny_port, tmp_path, override, error, default):
    """The JAX trainer builds a cls token and external features from these
    model keys (maskdit_tpu/train/trainer.py:158-159) and refuses streaming
    outside wds (:225-233); the port raises rather than train another model,
    and takes each key at its default."""
    key = override.split("=")[0]
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [override])
    match = "data.streaming requires data.category: wds" if error is ValueError else key
    with pytest.raises(error, match=match):
        Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1)
    cfg = cli.apply_overrides(cli.load_config(SMOKE), [default])
    Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1)


def _record_draws(trainer: Trainer, draws: list) -> None:
    """Make each train step first record the first draws of the generator
    it is handed (from a copy of it: the step's own draws are untouched)."""
    real = trainer._step_for_ratio

    def step_for_ratio(ratio):
        step = real(ratio)

        def run(state, batch, generator):
            copy = torch.Generator(generator.device)
            copy.set_state(generator.get_state())
            draws.append(torch.rand(8, generator=copy))
            return step(state, batch, generator)

        return run

    trainer._step_for_ratio = step_for_ratio


def test_resumed_run_draws_what_a_straight_run_draws(tiny_port, tmp_path):
    """A run of k steps resumed for k more draws, at steps k .. 2k-1, what a
    straight run of 2k steps draws there (each step's draws depend on the
    seed and the step, as the JAX trainer folds the step into its key), not
    the draws of steps 0 .. k-1 again. With the same batch at every step (one
    batch, no shuffle) the resumed run ends with the straight run's state,
    bit for bit."""
    k = 2
    cfg = cli.apply_overrides(cli.load_config(SMOKE),
                              ["data.length=8", "log.log_every=1", "log.ckpt_every=100"])

    def trainer(results, steps, draws):
        t = Trainer(cfg, results_dir=str(results), device="cpu", num_workers=1,
                    max_steps_override=steps)
        t.loader.shuffle = False  # the loader restarts at epoch 0 on resume
        _record_draws(t, draws)
        return t

    straight_draws, resumed_draws = [], []
    straight = trainer(tmp_path / "straight", 2 * k, straight_draws)
    assert straight.train() == 2 * k
    assert trainer(tmp_path / "resumed", k, resumed_draws).train() == k
    resumed = trainer(tmp_path / "resumed", k, resumed_draws)
    assert resumed.start_step == k and resumed.train() == 2 * k
    assert len(straight_draws) == len(resumed_draws) == 2 * k
    for a, b in zip(straight_draws, resumed_draws):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for s in range(k):
        assert not torch.equal(straight_draws[k + s], straight_draws[s])
    for name in ("params", "ema"):
        assert torch.equal(getattr(straight.state, name), getattr(resumed.state, name)), name
    for name in ("mu", "nu"):
        assert torch.equal(getattr(straight.state.opt_state, name),
                           getattr(resumed.state.opt_state, name)), name


def test_eval_hook_runs_after_each_checkpoint_on_the_ema(tiny_port, tmp_path):
    """``Trainer(eval_hook=...)`` calls ``hook(step, ema)`` after each
    checkpoint, with the EMA weights that checkpoint saved, and logs what it
    returns as ``eval/<name>`` at that step (JAX trainer.py:419-427)."""
    cfg = cli.apply_overrides(cli.load_config(SMOKE), ["log.log_every=1", "log.ckpt_every=2"])
    calls = []

    def hook(step, ema):
        calls.append((step, {k: v.clone() for k, v in ema.items()}))
        return {"fid": 10.0 + step, "is": 2.0}

    trainer = Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1,
                      max_steps_override=5, eval_hook=hook)
    assert trainer.train() == 5
    assert [step for step, _ in calls] == [2, 4]
    for step, ema in calls:
        saved = trainer.ckpt_mgr.restore(step)["ema"]
        assert sorted(ema) == sorted(saved)
        assert all(torch.equal(ema[k], saved[k]) for k in saved)
    with open(os.path.join(trainer.exp_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    evals = [r for r in records if "eval/fid" in r]
    assert [(r["step"], r["eval/fid"], r["eval/is"]) for r in evals] == [(2, 12.0, 2.0),
                                                                           (4, 14.0, 2.0)]


def test_cli_enable_eval_writes_fid(tiny_port, tmp_path):
    """``--enable_eval`` at tiny dims: after the step-2 checkpoint the EMA
    samples 4 seeds, a full-config SD-VAE (random weights) decodes them to
    PNGs, and their FID against ``eval.ref_path`` (random detector) goes to
    metrics.jsonl."""
    from maskdit_tpu_torch.evals import fid as fid_lib
    from maskdit_tpu_torch.evals.inception import make_detector, random_state_dict
    from maskdit_tpu_torch.utils.png import read_png, write_png
    from tests.test_torch_vae import write_random_vae

    vae = str(tmp_path / "autoencoder_kl.pth")
    write_random_vae(vae)
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        write_png(str(data / f"{i}.png"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    stats = str(tmp_path / "ref.npz")
    fid_lib.ref(str(data), stats, 3, make_detector(random_state_dict(0), "cpu"))
    results = str(tmp_path / "results")
    out = cli.main([*ARGS[:-2], "log.log_every=1", "log.ckpt_every=2", f"eval.ref_path={stats}",
                    "--results_dir", results, "--max_steps", "2", "--enable_eval",
                    "--eval_seeds", "0-3", "--cfg_scale", "1.5", "--num_steps", "2",
                    "--max_batch_size", "4", "--num_expected", "4", "--fid_batch_size", "4",
                    "--pretrained_path", vae, "--random_detector"])
    assert out["step"] == 2
    with open(os.path.join(out["exp_dir"], "metrics.jsonl")) as f:
        (record,) = [json.loads(line) for line in f if "eval/fid" in line]
    assert record["step"] == 2 and np.isfinite(record["eval/fid"])
    pngs = os.path.join(results, "fid", "edm-steps2-ckpt2_cfg1.5")
    assert sorted(os.listdir(pngs)) == [f"{s:06d}.png" for s in range(4)]
    assert read_png(os.path.join(pngs, "000000.png")).shape == (128, 128, 3)


def test_chip_smoke_trains_the_released_config():
    """chip_smoke.py's JSON config is configs/train/imagenet256-latent.yaml's
    model, train and data sections (the latent LMDB) but for data.root, which
    is [extract]'s LMDB, and the cuts it lists in TRAIN_CUTS."""
    released = config_lib.load(RELEASED).to_container()
    smoke = chip_smoke.TRAIN_CONFIG
    for section in ("model", "train"):
        assert set(smoke[section]) == set(released[section]), section
    assert smoke["data"] == {**released["data"], "root": chip_smoke.TRAIN_DATA_ROOT}
    assert smoke["data"]["category"] == "lmdb"
    for path, (was, now) in chip_smoke.TRAIN_CUTS.items():
        section, key = path.split(".")
        assert released[section][key] == was and smoke[section][key] == now, path
    for section in ("model", "train"):
        for key, value in released[section].items():
            if f"{section}.{key}" not in chip_smoke.TRAIN_CUTS:
                assert smoke[section][key] == value, f"{section}.{key}"
