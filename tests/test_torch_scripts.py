"""scripts/torch_fid_parity_gate.sh and scripts/torch_smoke_pipeline.sh.

Always: both parse (``bash -n``), name each of their stages' commands on the
port's CLIs and nothing of the JAX package or jax, run from their checkout
into a temporary root, keep the JAX gate's flags and TARGET_FID table; the
gate's real mode stops with exit 3 naming the missing asset (it downloads
nothing), and the pipeline's JSON copy of configs/train/synthetic-smoke.yaml
(for a machine without PyYAML) equals the YAML. The two whole runs with
DEVICE=cpu take 40-105 s each here, more than these tests' budget, so they
are marked ``slow``, as the JAX gate's run is (tests/test_fid_gate.py);
chip_smoke.py runs both on the card.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(ROOT, "scripts", "torch_fid_parity_gate.sh")
PIPELINE = os.path.join(ROOT, "scripts", "torch_smoke_pipeline.sh")
STAGES = {
    GATE: ["-m maskdit_tpu_torch.fid ref", "--random_detector",
           "tools/torch_validate_port.py", "-m maskdit_tpu_torch.eval_latent", "--dry-wire",
           "TARGET_FID", "DRY WIRING OK", "FID:", '--device "$DEVICE"', "exit 3"],
    PIPELINE: ["-m maskdit_tpu_torch.extract_latent", "-m maskdit_tpu_torch.lmdb2wds",
               "-m maskdit_tpu_torch.train", "configs/train/synthetic-smoke.yaml",
               "data.category=lmdb", "-m maskdit_tpu_torch.generate", "--pretrained_path",
               "-m maskdit_tpu_torch.fid ref", "-m maskdit_tpu_torch.fid calc",
               '--device "$DEVICE"', "PIPELINE COMPLETE"],
}


@pytest.mark.parametrize("path", [GATE, PIPELINE], ids=["gate", "pipeline"])
def test_script_parses_and_names_its_stages(path):
    subprocess.run(["bash", "-n", path], check=True)
    text = open(path).read()
    for needle in STAGES[path]:
        assert needle in text, needle
    assert "maskdit_tpu." not in text and "jax" not in text.lower()
    # from its own checkout, into a temporary root: no absolute directory
    assert 'cd "$(dirname "$0")/.."' in text and "mktemp -d" in text
    assert not re.search(r"\bcd /", text) and "/tmp/" not in text
    assert 'DEVICE="${DEVICE:-cuda}"' in text


def _flags_and_targets(path):
    text = open(path).read()
    flags = re.findall(r"^\s+(--[a-z-]+)\) ", text, re.M)
    targets = re.findall(r"then TARGET_FID=[0-9.]+|\bTARGET_FID=[0-9.]+$", text, re.M)
    return flags, targets


def test_gate_keeps_the_jax_gates_flags_and_targets():
    ours = _flags_and_targets(GATE)
    theirs = _flags_and_targets(os.path.join(ROOT, "scripts", "fid_parity_gate.sh"))
    assert ours == theirs and ours[0] == ["--res", "--cfg", "--seeds", "--dry-wire"]
    assert len(ours[1]) == 4


def test_gate_real_mode_stops_on_a_missing_asset(tmp_path):
    """Stage 1 checks assets/ and exits 3 naming the first missing file."""
    if os.path.exists(os.path.join(ROOT, "assets", "fid_stats")):
        pytest.skip("assets/fid_stats exists in this checkout")
    proc = subprocess.run(["bash", GATE, "--res", "512"], capture_output=True, text=True,
                          timeout=60, env={**os.environ, "DEVICE": "cpu"})
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "missing asset: assets/fid_stats/VIRTUAL_imagenet512.npz" in proc.stdout
    assert not os.path.exists(os.path.join(ROOT, "eval_out", "torch_fid_parity_512.log"))


def test_pipeline_json_config_equals_the_yaml():
    text = open(PIPELINE).read()
    block = re.search(r"<<'JSON'\n(.*?)\nJSON\n", text, re.S).group(1)
    with open(os.path.join(ROOT, "configs", "train", "synthetic-smoke.yaml")) as f:
        assert json.loads(block) == yaml.safe_load(f)


def _run(path, tmp_path, *args, **env):
    proc = subprocess.run(
        ["bash", path, *args], capture_output=True, text=True, timeout=900, cwd=ROOT,
        env={**os.environ, "DEVICE": "cpu", "PYTHON": sys.executable, **env},
    )
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.mark.slow
def test_gate_dry_wire_runs_on_cpu(tmp_path):
    out = _run(GATE, tmp_path, "--dry-wire", FID_GATE_TMP=str(tmp_path))
    assert "DRY WIRING OK" in out
    fid = float(re.search(r"FID: ([0-9.]+)", out).group(1))
    assert fid == fid and fid >= 0


@pytest.mark.slow
def test_smoke_pipeline_runs_on_cpu(tmp_path):
    root = tmp_path / "pipe"
    out = _run(PIPELINE, tmp_path, PIPE_ROOT=str(root))
    assert "=== PIPELINE COMPLETE ===" in out
    assert sorted(p.name for p in (root / "samples").glob("*.png")) == [
        f"{i:06d}.png" for i in range(8)]
    assert "FID: " in out
