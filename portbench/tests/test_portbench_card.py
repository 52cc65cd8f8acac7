"""On the card, at each cell's own size: the control (the reference in fp8
in the program's place) comes out not correct under the cell's limits,
and a sound run of the program comes out correct, on three seeds each;
in the sampling cell the reference with fp8 products alone fails too.
Run on a machine with a card: ``python -m pytest portbench/tests -m cuda``."""

from __future__ import annotations

import pytest
import torch

from conftest import REPO
from portbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _readings(cell: str, seed: int, what: str) -> dict:
    c = harness.load_cell(REPO, cell)
    run = c.kind.Run(harness.Ctx(c.config, c.mix, c.limits, seed, torch.device("cuda")))
    run.setup()
    if c.mix["kind"] == "sample":
        run.units(1)
    run.release()
    if what == "control_products":
        out = run.control(activations=False)
    else:
        out = run.control() if what == "control" else run.check()
    harness.free_device_memory()
    return harness.judge(out, c.limits["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["train256", "sample256", "train512"])
def test_control_fails_and_the_program_passes_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        control = _readings(cell, seed, "control")
        assert not all(harness.passed(c) for c in control.values()), (seed, control)
        program = _readings(cell, seed, "program")
        assert all(harness.passed(c) for c in program.values()), (seed, program)


@pytest.mark.cuda
def test_fp8_products_alone_fail_the_sampling_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        control = _readings("sample256", seed, "control_products")
        assert not all(harness.passed(c) for c in control.values()), (seed, control)
