"""The train CLI's ``--debug_nans`` and ``--use_wandb`` at the tiny dims on the
CPU, and the CLI's flags against the JAX CLI's.

``--debug_nans`` stands for the JAX CLI's ``jax_debug_nans`` (train.py:140-147):
the run stops with ``FloatingPointError`` at the first step whose batch
holds a NaN; without the flag it goes on, as the JAX run does.
``--use_wandb`` reaches the trainer's ``MetricLogger`` with the config's
``wandb.*`` keys (maskdit_tpu/train/trainer.py:255-264): a stub ``wandb``
module stands in for the package, which is not installed, and without it
the logger writes ``metrics.jsonl`` alone.
"""

import json
import math
import os
import re
import sys
import types

import pytest
import torch

from maskdit_tpu_torch.train import cli, trainer as trainer_lib
from tests.test_torch_model import patch_tiny_port
from tests.test_torch_trainer import ROOT, SMOKE

ARGS = ["--config", SMOKE, "--device", "cpu", "--num_workers", "1", "--max_steps", "4",
        "data.length=16", "log.log_every=1", "log.ckpt_every=100"]
NAN_STEP = 2


@pytest.fixture
def nan_batch(monkeypatch):
    """The batch of step NAN_STEP (0-based) holds a NaN."""
    patch_tiny_port(monkeypatch)
    real, calls = trainer_lib.to_device, []

    def to_device(batch, device):
        out = real(batch, device)
        if len(calls) == NAN_STEP:
            out["x"] = out["x"].clone()
            out["x"][0, 0, 0, 0] = float("nan")
        calls.append(1)
        return out

    monkeypatch.setattr(trainer_lib, "to_device", to_device)


def test_debug_nans_raises_at_the_first_nan_step(nan_batch, tmp_path):
    with pytest.raises(FloatingPointError, match=f"the loss .* at train step {NAN_STEP}$"):
        cli.main([*ARGS, "--results_dir", str(tmp_path), "--debug_nans"])


def test_without_debug_nans_the_run_goes_on(nan_batch, tmp_path):
    out = cli.main([*ARGS, "--results_dir", str(tmp_path)])
    losses = [x for r in out["history"] for x in r["losses"]]
    assert out["step"] == 4 and len(losses) == 4
    assert all(math.isfinite(x) for x in losses[:NAN_STEP]) and math.isnan(losses[NAN_STEP])
    assert not bool(torch.isfinite(out["state"].params).all())


def _trainer_with_gradient(monkeypatch, tmp_path, value: float):
    """A one-step trainer with ``--debug_nans`` whose gradient of the final
    layer's weight is ``value`` everywhere (the loss stays finite)."""
    patch_tiny_port(monkeypatch)
    cfg = cli.apply_overrides(cli.load_config(SMOKE), ["log.log_every=1"])
    t = trainer_lib.Trainer(cfg, results_dir=str(tmp_path), device="cpu", num_workers=1,
                            max_steps_override=1, debug_nans=True)
    hook = t.model.model.final_layer.linear.weight.register_hook(
        lambda g: torch.full_like(g, value))
    return t, hook


def test_debug_nans_names_the_first_parameter(monkeypatch, tmp_path):
    """A gradient that is NaN-free in the loss but not in one parameter's
    slice raises before the update, naming that parameter."""
    t, hook = _trainer_with_gradient(monkeypatch, tmp_path, float("nan"))
    params = t.state.params.clone()
    with pytest.raises(FloatingPointError, match=r"the gradient \(model.final_layer.linear"
                                                 r".weight first\) holds a NaN at train step 0$"):
        t.train()
    hook.remove()
    assert torch.equal(t.state.params, params)  # the update did not run


def test_debug_nans_passes_an_infinity_to_the_update(monkeypatch, tmp_path):
    """As ``jax_debug_nans``, an infinite gradient alone does not raise; Adam
    makes it inf / inf = NaN, so the updated parameters do, naming the
    parameter."""
    t, hook = _trainer_with_gradient(monkeypatch, tmp_path, float("inf"))
    with pytest.raises(FloatingPointError, match=r"the updated parameters \(model.final_layer"
                                                 r".linear.weight first\) holds a NaN at train "
                                                 r"step 0$"):
        t.train()
    hook.remove()


class StubWandb(types.ModuleType):
    """What the logger calls of wandb: init, log, finish."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logs, self.finished = [], [], 0

    def init(self, **kwargs):
        self.inits.append(kwargs)

    def log(self, metrics, step=None):
        self.logs.append((step, dict(metrics)))

    def finish(self):
        self.finished += 1


def test_use_wandb_reaches_the_logger(monkeypatch, tmp_path):
    patch_tiny_port(monkeypatch)
    stub = StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    overrides = ["wandb.entity=MaskDiT", "wandb.project=MaskDiT-smoke", "wandb.group=pretrain"]
    out = cli.main(["--results_dir", str(tmp_path), "--use_wandb", *ARGS, *overrides])
    (init,) = stub.inits
    assert {k: init[k] for k in ("entity", "project", "group")} == {
        "entity": "MaskDiT", "project": "MaskDiT-smoke", "group": "pretrain"}
    assert init["config"]["model"]["model_type"] == "DiT-S/2"
    assert [s for s, _ in stub.logs] == [1, 2, 3, 4] and stub.finished == 1
    assert all("train/loss" in m for _, m in stub.logs)
    with open(os.path.join(out["exp_dir"], "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


def test_use_wandb_without_wandb_falls_back_to_jsonl(monkeypatch, tmp_path, capsys):
    patch_tiny_port(monkeypatch)
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    out = cli.main([*ARGS, "--results_dir", str(tmp_path), "--use_wandb"])
    assert "wandb unavailable" in capsys.readouterr().err
    with open(os.path.join(out["exp_dir"], "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 4]


def test_flags_default_off():
    args = cli.build_parser().parse_args(["--config", SMOKE])
    assert not args.debug_nans and not args.use_wandb


def _flags(path: str) -> set:
    with open(path) as f:
        return set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))


def test_cli_takes_every_flag_of_the_jax_cli_but_mesh():
    """Every flag of the repo's train.py but ``--mesh`` (the FSDP and tensor
    axes, not ported by design) parses in the port's CLI."""
    theirs = _flags(os.path.join(ROOT, "train.py"))
    ours = {a for action in cli.build_parser()._actions for a in action.option_strings}
    assert "--debug_nans" in theirs and "--use_wandb" in theirs
    assert theirs - ours == {"--mesh"}
