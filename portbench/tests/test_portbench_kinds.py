"""Each kind run end to end on the CPU at a tiny size through the port's
real entry points (its plain kernels), against the reference; the planted
faults and the fp8 control coming out not correct; no JAX in a run's
process; no result without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import REPO, make_root, patch_tiny_model
from portbench import faults, harness

SEED = 2 ** 31 + 17


def test_train_runs_end_to_end(tiny_root):
    line = harness.run_cell(tiny_root, "tiny-train", SEED, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_images_per_s", "train_step_ms_p90", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["train_images_per_s"]["value"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"loss_gap", "grad_norm_gap", "update_norm_gap",
                                   "ema_update_norm_gap"}


def test_sample_runs_end_to_end(tiny_root):
    line = harness.run_cell(tiny_root, "tiny-sample", SEED, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] % 3 == 0 and line["attempted"] >= 3
    assert set(line["metrics"]) == {"sample_images_per_s", "peak_mem_gib", "setup_s"}
    assert set(line["checks"]) == {"sample_gap", "denoise_gap"}


def test_sample_keeps_the_denoiser_of_the_timed_batches(tiny_root):
    """The window's own evaluations are kept for the denoiser's check: the
    first evaluation of each step in ``denoise_steps``, its input and
    output as the program's denoiser saw and gave them."""
    c = harness.load_cell(tiny_root, "tiny-sample")
    run = c.kind.Run(harness.Ctx(c.config, c.mix, c.limits, SEED, torch.device("cpu")))
    run.setup()
    run.units(2)
    for latents, _, _, kept in run.done:
        assert sorted(kept) == [2 * i for i in c.mix["denoise_steps"]]
        x, sigma, denoised = kept[0]
        assert torch.equal(sigma, torch.full_like(sigma, c.mix["sigma_max"]))
        assert torch.allclose(x, latents * c.mix["sigma_max"])
        assert denoised.shape == latents.shape
    compared = run._compared()
    assert compared["x"].shape[0] == c.mix["compare_images"] * len(c.mix["denoise_steps"])


def test_same_seed_same_inputs(tiny_root):
    cell = harness.load_cell(tiny_root, "tiny-train")
    runs = [cell.kind.Run(harness.Ctx(cell.config, cell.mix, cell.limits, s, torch.device("cpu")))
            for s in (SEED, SEED, SEED + 1)]
    a, b, c = (r.feed(3) for r in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["noise"], c["noise"])
    assert not torch.equal(a["noise"], runs[0].feed(4)["noise"])


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-sample"])
def test_port_matches_reference_in_fp32(cell, tmp_path, monkeypatch):
    """The port computing in fp32 agrees with the plain reference to fp32
    rounding: the reference computes the port's function. (The EMA's change
    over three steps is a few fp32 ulps of each weight, so it is left out
    here.)"""
    patch_tiny_model(monkeypatch)
    root = make_root(tmp_path, compute_dtype="float32")
    checks = harness.run_cell(root, cell, SEED, 0.1, False, "cpu")["checks"]
    values = {k: v["value"] for k, v in checks.items() if k != "ema_update_norm_gap"}
    assert max(values.values()) < 1e-4, values


@pytest.mark.parametrize("cell,fault", [
    ("tiny-train", "unchanged"), ("tiny-train", "half_batch"), ("tiny-train", "token"),
    ("tiny-sample", "unchanged"), ("tiny-sample", "token"),
])
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    """A run whose timed path is broken underneath comes out not correct
    under the cell's limits."""
    cell_ = harness.load_cell(tiny_root, cell)
    real = cell_.kind.Run

    class Faulty(real):
        def setup(self):
            self._fault = faults.plant(fault, cell_.mix["kind"], self)
            self._fault.__enter__()
            super().setup()

        def release(self):
            self._fault.__exit__(None, None, None)
            super().release()

    orig = harness.load_cell
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cell_.kind, "Run", Faulty)
        mp.setattr(harness, "load_cell", lambda root, w: cell_ if w == cell else orig(root, w))
        line = harness.run_cell(tiny_root, cell, SEED, 0.1, False, "cpu")
    assert not line["correct"], line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-sample"])
def test_control_reads_three_times_the_program(tiny_root, cell):
    """The control (the reference in fp8 in the program's place) moves some
    number three times as far from the reference as the program does: the
    separation the limits are set in. (At the cells' own size it fails
    their limits: test_portbench_card.py.)"""
    c = harness.load_cell(tiny_root, cell)
    run = c.kind.Run(harness.Ctx(c.config, c.mix, c.limits, SEED, torch.device("cpu")))
    run.setup()
    if c.mix["kind"] == "sample":
        run.units(1)
    run.release()
    program, control = run.check(), run.control()
    assert any(control[k] >= 3 * program[k] for k in program), (program, control)


def test_run_imports_no_jax(tmp_path):
    """A whole run, in a process of its own, loads no module whose
    top-level name is jax, jaxlib, flax or maskdit_tpu (maskdit_tpu_torch
    is the port and may load)."""
    root = make_root(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        sys.path.insert(0, {str(REPO / "portbench" / "tests")!r})
        import pytest
        from conftest import patch_tiny_model
        from portbench import harness
        from portbench.run import forbidden_modules
        with pytest.MonkeyPatch.context() as mp:
            patch_tiny_model(mp)
            for cell in ("tiny-train", "tiny-sample"):
                harness.run_cell({str(root)!r}, cell, 5, 0.1, True, "cpu")
        assert "maskdit_tpu_torch" in sys.modules
        print("FORBIDDEN", forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench.run import forbidden_modules

    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "maskdit_tpu"):
            monkeypatch.delitem(sys.modules, name)
    for name in ("maskdit_tpu_torch", "maskdit_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "maskdit_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert forbidden_modules() == ["jax", "maskdit_tpu.models"]


def test_no_result_without_a_card():
    """Where torch finds no card the run exits non-zero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(REPO / "portbench" / "run.py"), "--workload",
                          "train256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    runs no cell."""
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "train256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    # the bytecode it compiled went to the checkout's cache, not beside the sources
    assert (tmp_path / "build" / "portbench" / "pycache").is_dir()
    assert not list((tmp_path / "portbench").rglob("__pycache__"))
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["portbench"]
