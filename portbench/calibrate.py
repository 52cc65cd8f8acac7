"""Readings for setting a cell's limits: the program's on many seeds, the
control's (the reference in fp8 in the program's place; for a sampling
cell also with fp8 products alone, ``--control-products``) and planted
faults', all at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload train256 --seeds 101,102,... \
        [--control 3] [--control-products 0] [--faults half_batch,token] \
        [--fault-seeds 3] [--out DIR]

A training cell's readings come from its set-up (the checked first steps)
and need no window; a sampling cell's from one batch. Each reading goes to
``<out>/<workload>.jsonl`` (default ``build/portbench/calibrate``); the summary (the largest sound
reading, the smallest control and fault readings of each number) is
printed last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device, what: str = "program", fault: str = None) -> dict:
    from portbench import faults, harness

    run = cell.kind.Run(harness.Ctx(cell.config, cell.mix, cell.limits, seed, device))
    kind = cell.mix["kind"]
    with (faults.plant(fault, kind, run) if fault else contextlib.nullcontext()):
        run.setup()
        if kind == "sample":
            run.units(1)
    run.release()
    if what == "control_products":
        return run.control(activations=False)
    return run.control() if what == "control" else run.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--control-products", type=int, default=0)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--out", default=str(ROOT / "build" / "portbench" / "calibrate"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    jobs = [("program", None, s) for s in seeds]
    jobs += [("control", None, s) for s in seeds[:args.control]]
    jobs += [("control_products", None, s) for s in seeds[:args.control_products]]
    jobs += [("program", f, s) for f in filter(None, args.faults.split(","))
             for s in seeds[:args.fault_seeds]]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    summary: dict = {}
    for what, fault, seed in jobs:
        t0 = time.perf_counter()
        r = readings(cell, seed, device, what, fault)
        label = fault or what
        rec = {"workload": args.workload, "as": label, "seed": seed, "readings": r,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        with open(out / f"{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        for name, value in r.items():
            summary.setdefault((label, name), []).append(value)
        harness.free_device_memory()
    for (label, name), values in sorted(summary.items()):
        pick = max if label == "program" else min
        print(f"SUMMARY {args.workload} {label} {name} {'max' if pick is max else 'min'}="
              f"{pick(values)!r} n={len(values)} all={values!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
