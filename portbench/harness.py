"""Run one cell of BENCHMARK.json once, driven by the files named there.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
harness finds, by name alone:

  * the configuration's file: ``configs[].file`` in BENCHMARK.json;
  * the mix: ``portbench/mixes/<traffic>.json``, whose ``kind`` names
  * the kind of work: ``portbench/kinds/<kind>.py`` (a ``Run`` class);
  * the cell's limits for ``correct``: ``portbench/limits/<workload>.json``;
  * each per-layer metric's reader: ``portbench/metrics/<metric>.py`` (a
    ``read(view)`` function returning a number, or None where it finds
    nothing to read).

So a later cell, mix, kind or metric comes as new files and entries, with
no edit here. A ``Run`` sets up the program from the seed (weights, state,
the checked first units, warm-up), times the window, runs more units for a
trace, frees the program's state and then compares what it produced with
``portbench/reference``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np

GIB = float(1 << 30)


class MetricError(RuntimeError):
    """A reader found the trace inconsistent with the cell's shapes."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    kind: Any  # the kind's module
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list  # (entry, reader module) this cell reports


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, without a
    list, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(root: Path, workload: str) -> Cell:
    """Everything cell ``workload`` of ``root/BENCHMARK.json`` names."""
    root = Path(root)
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    here = root / "portbench"
    mix = read_json(here / "mixes" / f"{w['traffic']}.json")
    kind = load_module(here / "kinds" / f"{mix['kind']}.py", f"portbench_kind_{mix['kind']}")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [
        (m, load_module(here / "metrics" / f"{m['name']}.py", f"portbench_metric_{m['name']}"))
        for m in bench["per_layer"] if _reports(m, workload, names)
    ]
    limits = read_json(here / "limits" / f"{workload}.json")
    return Cell(workload, w["chips"], config, mix, limits, kind, e2e, per_layer)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


@dataclasses.dataclass
class Ctx:
    """What a kind's ``Run`` is given."""

    config: dict
    mix: dict
    limits: dict
    seed: int
    device: Any  # torch.device
    phases: list = dataclasses.field(default_factory=list)  # (name, perf_counter)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, once the device has caught up."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases.append((phase, time.perf_counter()))

    def subseed(self, tag: str) -> int:
        return subseed(self.seed, tag)

    def generator(self, tag: str):
        import torch

        return torch.Generator(device=self.device).manual_seed(self.subseed(tag))


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader is given: the trace of ``units``
    profiled units, the device-only trace of as many more (``device``), the
    cell's shapes (``Run.layout()``), the window's end-to-end values and
    the card's peaks."""

    trace: Any
    device: Any
    layout: dict
    units: int
    window: dict
    peak_flops: float
    bandwidth: float


def judge(readings: dict, limits: dict) -> dict:
    """{name: {value, limit}} for every limit; a reading that is missing or
    not finite is recorded as NaN, which no limit passes."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        out[name] = {"value": float(value), "limit": float(limit)}
    return out


def passed(check: dict) -> bool:
    return math.isfinite(check["value"]) and check["value"] <= check["limit"]


def free_device_memory() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, phases: Optional[list] = None) -> dict:
    """Run the cell once and return the result line (without printing).
    Set-up's phases, from ``t_start`` on (``phases``: those before this
    call), go to standard error."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(root, workload)
    device = torch.device(device)
    ctx = Ctx(cell.config, cell.mix, cell.limits, seed, device, list(phases or []))
    run = cell.kind.Run(ctx)
    on_card = device.type == "cuda"
    run.setup()
    ctx.mark("setup")
    setup_s = ctx.phases[-1][1] - t_start
    ends = [t_start] + [t for _, t in ctx.phases]
    print("setup_phases " + " ".join(f"{name} {t - t0:.3f}" for (name, t), t0
                                     in zip(ctx.phases, ends)), file=sys.stderr, flush=True)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    window = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    values = dict(window["metrics"], setup_s=setup_s, peak_mem_gib=peak / GIB)

    device_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    line: dict = {}
    if trace:
        from portbench import counts
        from portbench import trace as trace_lib

        n = run.profile_units
        metrics = {}
        if on_card:
            busy = trace_lib.capture(run.units, n, host=False)
            tr = trace_lib.capture(run.units, n)
            flops, bandwidth = counts.peaks(device_info["kind"])
            view = View(tr, busy, run.layout(), n, window["metrics"], flops, bandwidth)
            for entry, reader in cell.per_layer:
                value = reader.read(view)
                if value is not None:
                    metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
            device_info.update(busy_s=busy.busy_s, window_s=busy.window_s)
            line["breakdown"] = tr.breakdown()
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"kind {cell.mix['kind']!r} gives no {m['name']!r}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    run.release()
    free_device_memory()
    checks = judge(run.check(), cell.limits["limits"])
    failed = sum(not passed(c) for c in checks.values())
    return {
        "correct": failed == 0,
        "attempted": window["attempted"],
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
        **line,
        "checks": checks,
    }
