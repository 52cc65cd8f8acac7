"""Device traces: capture a few units under torch.profiler and reduce the
events to what the per-layer metrics read.

Every device event (kernel, memcpy, memset) gets one category:

  * ``kernel:<entry>`` where its launch lies inside the program's profiler
    range ``maskdit::<entry>`` (``maskdit_tpu_torch/ops/build.launch_range``,
    around each of its hand-written kernels; two of them can share a kernel
    name, so the name alone cannot tell them apart);
  * ``feed`` where it lies inside the benchmark's own range
    ``portbench::feed`` (the seeded inputs of each unit);
  * ``gemm`` where the innermost host op that launched it is a matrix
    product (``GEMM_OPS``), or its name is a cuBLAS / CUTLASS kernel's;
  * ``glue`` otherwise: PyTorch's elementwise, reduction, copy, memcpy and
    memset work.

A launch is matched to its host call by the profiler's correlation id, and
the call to the ranges and ops open around it on its thread. The busy time
is the union of the device events' intervals; the idle gaps between them
are named by the innermost host op (else runtime call) running on the
launching thread when the gap began.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import tempfile
import time

PROGRAM_RANGE = "maskdit::"
FEED_RANGE = "portbench::feed"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation") + CALL_CATS
GEMM_OPS = frozenset({
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm", "aten::addmv",
    "aten::mv", "aten::dot", "aten::_scaled_mm", "aten::_addmm_activation",
})
GEMM_NAME = re.compile(r"gemm|gemv|cutlass|cublas|nvjet|xmma|wgmma|s16816|s1688", re.I)


@dataclasses.dataclass
class Trace:
    """The reduced events of one traced window."""

    ops: list  # (category, name, start_us, dur_us) per device event
    ranges: collections.Counter  # host ranges maskdit::<entry> opened, by entry
    window_s: float  # the traced window's wall seconds
    gaps: list  # (host op, seconds) per idle gap between device events

    def seconds(self, category: str) -> float:
        return sum(dur for cat, _, _, dur in self.ops if cat == category) / 1e6

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, None
        for _, _, ts, dur in sorted(self.ops, key=lambda o: o[2]):
            if end is None or ts > end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by category and kernel
        family) and the idle time by what the host was doing, in seconds."""
        ops = collections.Counter()
        for cat, name, _, dur in self.ops:
            ops[cat if cat.startswith("kernel:") else f"{cat} {family(name)}"] += dur / 1e6
        gaps = collections.Counter()
        for name, seconds in self.gaps:
            gaps[name] += seconds
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def family(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0] or name
    return name.rsplit("::", 1)[-1].strip()[:80]


def feed_range():
    """The benchmark's profiler range around a unit's inputs while
    torch.profiler records, else a context that does nothing."""
    import contextlib

    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(FEED_RANGE)
    return contextlib.nullcontext()


def capture(run_units, n_units: int, host: bool = True) -> Trace:
    """Profile ``run_units(n_units)`` on the card and reduce its events. With
    ``host`` false the profiler records the device alone: no host ops or
    ranges, so it hardly slows the host that feeds the card, and the union
    of the device events over the window's wall time is the device's busy
    share at the pace of an untraced run. The trace passes through a file
    in the temporary directory, removed after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [
        ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_units(n_units)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    return reduce(events["traceEvents"] if isinstance(events, dict) else events, window)


def _sweep(host: list, points: list) -> dict:
    """For each point (time, key) on a thread, the stack of host events
    (cat, name) open at that time, innermost last."""
    items = [(e["ts"], 0, -e.get("dur", 0.0), i) for i, e in enumerate(host)]
    items += [(ts, 1, 0.0, key) for ts, key in points]
    items.sort(key=lambda t: t[:3])
    stack, found = [], {}
    for ts, kind, _, ref in items:
        while stack and stack[-1][0] < ts:
            stack.pop()
        if kind == 0:
            e = host[ref]
            stack.append((e["ts"] + e.get("dur", 0.0), e["cat"], e["name"]))
        else:
            found[ref] = [(cat, name) for _, cat, name in stack]
    return found


def _gemm(name: str, stack: list) -> bool:
    ops = [n for cat, n in stack if cat == "cpu_op"]
    return (bool(ops) and ops[-1] in GEMM_OPS) or bool(GEMM_NAME.search(name))


def reduce(events: list, window_s: float) -> Trace:
    """Categorise the device events of a Chrome trace (see the module
    docstring) and name its idle gaps."""
    host = collections.defaultdict(list)
    calls = {}
    ranges = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in HOST_CATS:
            continue
        host[(e.get("pid"), e.get("tid"))].append(e)
        name = str(e.get("name", ""))
        if e["cat"] == "user_annotation" and name.startswith(PROGRAM_RANGE):
            ranges[name[len(PROGRAM_RANGE):]] += 1
        corr = e.get("args", {}).get("correlation")
        if e["cat"] in CALL_CATS and corr is not None:
            calls[corr] = ((e.get("pid"), e.get("tid")), e["ts"])
    device = sorted((e for e in events
                     if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                    key=lambda e: e["ts"])

    # the host stack at each launch call, and at the start of each idle gap
    points = collections.defaultdict(list)
    for corr, (thread, ts) in calls.items():
        points[thread].append((ts, ("call", corr)))
    gap_list, end, last_thread = [], None, None
    for i, e in enumerate(device):
        thread = calls.get(e.get("args", {}).get("correlation"), (last_thread, None))[0]
        if end is not None and e["ts"] > end and thread is not None:
            gap_list.append((thread, end, e["ts"] - end))
            points[thread].append((end, ("gap", len(gap_list) - 1)))
        end = max(end or e["ts"], e["ts"] + e.get("dur", 0.0))
        last_thread = thread
    stacks = {}
    for thread, pts in points.items():
        stacks.update(_sweep(host.get(thread, []), pts))

    ops = []
    for e in device:
        name = str(e.get("name", ""))
        stack = stacks.get(("call", e.get("args", {}).get("correlation")), [])
        names = [n for cat, n in stack if cat == "user_annotation"]
        entry = next((n[len(PROGRAM_RANGE):] for n in reversed(names)
                      if n.startswith(PROGRAM_RANGE)), None)
        if entry is not None:
            cat = "kernel:" + entry
        elif FEED_RANGE in names:
            cat = "feed"
        elif _gemm(name, stack):
            cat = "gemm"
        else:
            cat = "glue"
        ops.append((cat, name, float(e["ts"]), float(e.get("dur", 0.0))))
    gaps = []
    for i, (_, _, dur) in enumerate(gap_list):
        stack = stacks.get(("gap", i), [])
        ops_open = [n for cat, n in stack if cat in ("cpu_op", "user_annotation")]
        name = (ops_open or [n for _, n in stack] or ["host outside any op"])[-1]
        gaps.append((name, dur / 1e6))
    return Trace(ops, ranges, window_s, gaps)
