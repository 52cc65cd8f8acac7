"""Run one cell of the benchmark of maskdit_tpu_torch once, on the card.

    python3 portbench/run.py --workload train256 --seed 7 --seconds 35 --trace 0

prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number ``correct`` compared, with
its limit (also the last lines of standard error). It exits non-zero and
prints no result where no card is there, where the cell asks for more
cards than there are, or where JAX or the JAX package was imported.
Kernel builds and caches stay inside the checkout (``build/``), Python's
bytecode too: where the installed packages carry none, every process
would compile torch's sources again (seconds that swing with the host's
load), so it is written once under ``build/portbench/pycache`` and read
from there after.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT_DIR, "build", "portbench", "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(ROOT_DIR)
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "maskdit_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``maskdit_tpu_torch`` is the port, not ``maskdit_tpu``)."""
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    phases = [("import", time.perf_counter())]
    chips = harness.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.empty(1, device="cuda")  # the context
    phases.append(("context", time.perf_counter()))
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", t_start=T_START, phases=phases)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were imported: {found}",
              file=sys.stderr)
        return 3
    for name, check in line["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
