"""The PyTorch port imports neither jax nor anything of the JAX package.

Checked in a fresh interpreter: this test process has jax and maskdit_tpu
loaded already (tests/conftest.py imports them). The JAX package's
``utils/logging.py`` and ``utils/config.py`` import no jax, so a check for
jax alone misses an import of them: the check forbids every module named
``maskdit_tpu`` or ``maskdit_tpu.*`` as well, in the port, in chip_smoke.py
and in tools/torch_overfit_gate.py. The evaluation and data paths' modules
also import no Pillow, which the card's machine need not have.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# named so that a module the walk below could miss is still imported
MODULES = [
    "maskdit_tpu_torch",
    "maskdit_tpu_torch.generate",
    "maskdit_tpu_torch.eval_latent",
    "maskdit_tpu_torch.evaluator",
    "maskdit_tpu_torch.fid",
    "maskdit_tpu_torch.evals",
    "maskdit_tpu_torch.evals.evaluator",
    "maskdit_tpu_torch.evals.fid",
    "maskdit_tpu_torch.evals.inception",
    "maskdit_tpu_torch.models",
    "maskdit_tpu_torch.models.vae",
    "maskdit_tpu_torch.ops.flash",
    "maskdit_tpu_torch.ops.flash_batched",
    "maskdit_tpu_torch.ops.flash_big",
    "maskdit_tpu_torch.ops.fused_adam",
    "maskdit_tpu_torch.parallel",
    "maskdit_tpu_torch.parallel.data_parallel",
    "maskdit_tpu_torch.parallel.dist",
    "maskdit_tpu_torch.parallel.mesh",
    "maskdit_tpu_torch.parallel.sharded",
    "maskdit_tpu_torch.models.masking",
    "maskdit_tpu_torch.sampling.generate",
    "maskdit_tpu_torch.data",
    "maskdit_tpu_torch.data.datasets",
    "maskdit_tpu_torch.data.lmdb_lite",
    "maskdit_tpu_torch.data.native_io",
    "maskdit_tpu_torch.data.wds",
    "maskdit_tpu_torch.extract_latent",
    "maskdit_tpu_torch.lmdb2wds",
    "maskdit_tpu_torch.train",
    "maskdit_tpu_torch.train.cli",
    "maskdit_tpu_torch.train.trainer",
    "maskdit_tpu_torch.utils.ckpt",
    "maskdit_tpu_torch.utils.config",
    "maskdit_tpu_torch.utils.logging",
    "maskdit_tpu_torch.utils.png",
    "maskdit_tpu_torch.utils.port",
    "maskdit_tpu_torch.utils.precision",
    "maskdit_tpu_torch.utils.profiling",
]
# the evaluation path: seeds -> PNGs -> FID runs where Pillow is missing
PNG_PATH = [
    "maskdit_tpu_torch.generate",
    "maskdit_tpu_torch.eval_latent",
    "maskdit_tpu_torch.fid",
    "maskdit_tpu_torch.evaluator",
    "maskdit_tpu_torch.evals",
    "maskdit_tpu_torch.models.vae",
    "maskdit_tpu_torch.utils.png",
    "maskdit_tpu_torch.train.cli",
]
# the data path: images -> latents -> shards -> training, on the same machine
DATA_PATH = [
    "maskdit_tpu_torch.data",
    "maskdit_tpu_torch.extract_latent",
    "maskdit_tpu_torch.lmdb2wds",
    "maskdit_tpu_torch.train.trainer",
]

FORBIDDEN = (
    "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'maskdit_tpu')\n"
    "             or m.startswith(('jax.', 'flax.', 'maskdit_tpu.')))\n"
    "assert not bad, bad\n"
    "print('ok')\n"
)


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )


def test_port_imports_no_jax():
    """Every module of the port, those the walk finds and those named."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import maskdit_tpu_torch\n"
        "walked = [m.name for m in pkgutil.walk_packages(maskdit_tpu_torch.__path__,\n"
        "                                                'maskdit_tpu_torch.')\n"
        "          if not m.name.endswith('__main__')]\n"
        f"for m in sorted(set(walked) | set({MODULES!r})):\n"
        "    importlib.import_module(m)\n"
        f"assert set({MODULES!r}) <= set(sys.modules)\n"
        + FORBIDDEN
    )
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _imports_no_pillow(modules: list) -> str:
    return (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'PIL' or m.startswith('PIL.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )


def test_evaluation_path_imports_no_pillow():
    proc = _run(_imports_no_pillow(PNG_PATH))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_data_path_imports_no_pillow():
    """Latent extraction decodes PNGs with the port's codec and crops them
    with its own resample."""
    proc = _run(_imports_no_pillow(DATA_PATH))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def _script_imports(path: str, must_name: str) -> str:
    """Code that runs the script ``path`` as a module (not as __main__) and
    then imports every module that any import statement in it names (its
    phases import the port inside functions)."""
    return (
        "import ast, importlib, runpy, sys\n"
        f"runpy.run_path({path!r}, run_name='script')\n"
        f"tree = ast.parse(open({path!r}).read())\n"
        "names = set()\n"
        "for node in ast.walk(tree):\n"
        "    if isinstance(node, ast.Import):\n"
        "        names.update(a.name for a in node.names)\n"
        "    elif isinstance(node, ast.ImportFrom) and node.module:\n"
        "        names.add(node.module)\n"
        "        for a in node.names:\n"
        "            try:\n"
        "                importlib.import_module(f'{node.module}.{a.name}')\n"
        "            except ImportError:\n"
        "                pass\n"
        f"assert {must_name!r} in names, sorted(names)\n"
        "for m in sorted(names):\n"
        "    importlib.import_module(m)\n"
        + FORBIDDEN
    )


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py drives the port alone."""
    proc = _run(_script_imports("chip_smoke.py", "maskdit_tpu_torch.train"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_torch_overfit_gate_imports_no_jax():
    """tools/torch_overfit_gate.py runs on the card's machine, which has no jax."""
    proc = _run(_script_imports("tools/torch_overfit_gate.py", "maskdit_tpu_torch.train.trainer"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_multiprocess_test_worker_imports_no_jax():
    """tests/test_torch_dist_worker.py runs each process of the multi-process
    tests; it imports the port alone."""
    proc = _run(_script_imports("tests/test_torch_dist_worker.py", "maskdit_tpu_torch.models"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_mesh_test_worker_imports_no_jax():
    """tests/test_torch_mesh_worker.py runs each process of the mesh tests;
    it imports the port alone, the mesh's modules among them."""
    proc = _run(_script_imports("tests/test_torch_mesh_worker.py",
                                "maskdit_tpu_torch.parallel.sharded"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


TOOL_TWINS = sorted(f for f in os.listdir(os.path.join(ROOT, "tools"))
                    if f.startswith("torch_") and f.endswith(".py"))


@pytest.mark.parametrize("tool", TOOL_TWINS)
def test_torch_tool_imports_no_jax(tool):
    """Each tools/torch_*.py runs on the card's machine, which has no jax:
    importing it, and every module its import statements name, loads
    neither jax nor the JAX package."""
    proc = _run(_script_imports(f"tools/{tool}", "os"))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_every_tool_twin_is_checked():
    assert {"torch_validate_port.py", "torch_mu_dtype_curve.py", "torch_trace_capture.py",
            "torch_trace_report.py", "torch_attn_bench.py",
            "torch_overfit_gate.py"} <= set(TOOL_TWINS)
