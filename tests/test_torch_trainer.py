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


def test_unported_options_raise(tiny_port, tmp_path):
    for override in ("train.amp_grads=true", "train.ema_every=2", "train.pad_to_max=true",
                     "data.category=lmdb"):
        cfg = cli.apply_overrides(cli.load_config(SMOKE), [override])
        with pytest.raises(NotImplementedError):
            Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1)


def test_chip_smoke_trains_the_released_config():
    """chip_smoke.py's JSON config is configs/train/imagenet256-latent.yaml's
    model and train sections, and its data shapes, except for the cuts it
    lists in TRAIN_CUTS."""
    released = config_lib.load(RELEASED).to_container()
    smoke = chip_smoke.TRAIN_CONFIG
    for section in ("model", "train"):
        assert set(smoke[section]) == set(released[section]), section
    for key in ("dataset", "resolution", "num_channels"):
        assert smoke["data"][key] == released["data"][key]
    for path, (was, now) in chip_smoke.TRAIN_CUTS.items():
        section, key = path.split(".")
        assert released[section][key] == was and smoke[section][key] == now, path
    for section in ("model", "train"):
        for key, value in released[section].items():
            if f"{section}.{key}" not in chip_smoke.TRAIN_CUTS:
                assert smoke[section][key] == value, f"{section}.{key}"
