"""The PyTorch port never imports jax.

Checked in a fresh interpreter: this test process has jax loaded already
(tests/conftest.py imports it).
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "maskdit_tpu_torch",
    "maskdit_tpu_torch.generate",
    "maskdit_tpu_torch.models",
    "maskdit_tpu_torch.ops.flash_batched",
    "maskdit_tpu_torch.ops.fused_adam",
    "maskdit_tpu_torch.models.masking",
    "maskdit_tpu_torch.sampling.generate",
    "maskdit_tpu_torch.data",
    "maskdit_tpu_torch.train",
    "maskdit_tpu_torch.train.trainer",
    "maskdit_tpu_torch.utils.ckpt",
    "maskdit_tpu_torch.utils.port",
    "maskdit_tpu_torch.utils.profiling",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port alone: its imports reach no jax."""
    code = (
        "import sys, runpy\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
