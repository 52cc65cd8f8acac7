"""Summarize a torch.profiler Chrome trace: where the device time goes.

Usage: python tools/torch_trace_report.py TRACE_DIR [n_steps]

The twin of tools/trace_report.py. It reads the newest Chrome trace
(``*.json`` or ``*.json.gz``) under TRACE_DIR, as written by
``maskdit_tpu_torch/utils/profiling.trace`` (tools/torch_trace_capture.py),
takes its GPU kernel, memcpy and memset events, and prints the device
milliseconds per step, then the time by category, then the top kernel
families and the top single kernels. Categories: GEMM (cuBLAS and CUTLASS
kernels), each of the port's kernels #1-#7, elementwise, reduction, copy /
memcpy / memset, other. A port kernel is known by the profiler range
``maskdit::<entry>`` (its C entry point's name) that its wrapper opens
around the launch (``ops/build.launch_range``): #2 and #4 (and #3 and #5)
launch kernels of the same name. One H100 SXM: 989 TFLOP/s dense bf16,
3.35 TB/s HBM3.

Where it differs from the JAX report: the events are CUDA kernels, not XLA
ops, grouped by kernel name and launch range instead of HLO category; a
torch trace carries no ``bytes_accessed``, so the GB and GB/s columns are
dropped.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from maskdit_tpu_torch.ops.build import RANGE_PREFIX  # noqa: E402

PEAK_BF16_TFLOPS = 989.0
HBM_TBPS = 3.35

# the port's kernels by their wrappers' launch ranges (ops/build.launch_range)
PORT_KERNELS = {
    "packed_attention_fwd": "#1 packed_attention_fwd",
    "packed_attention_bwd": "#2 packed_attention_bwd",
    "packed_attention_big_fwd": "#3 packed_attention_big_fwd",
    "packed_attention_big_bwd": "#4 packed_attention_big_bwd",
    "flash_fwd": "#5 flash_fwd",
    "flash_bwd": "#6 flash_bwd",
    "fused_adam_ema": "#7 fused_adam_ema",
}
CATEGORIES = (
    ("GEMM", re.compile(r"gemm|gemv|cutlass|cublas|nvjet|xmma|s16816|s1688|wgmma", re.I)),
    ("copy / memcpy / memset", re.compile(r"^Memcpy|^Memset|copy|CatArray", re.I)),
    ("reduction", re.compile(r"reduce|softmax|norm", re.I)),
    ("elementwise", re.compile(r"elementwise", re.I)),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def newest_trace(trace_dir: str) -> str:
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not paths:
        raise SystemExit(f"no *.json or *.json.gz trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_events(trace_dir: str) -> list[dict]:
    """The device events (kernels, memcpy, memset) of the newest trace, each
    with ``category`` set."""
    path = newest_trace(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        d = json.load(f)
    evs = d["traceEvents"] if isinstance(d, dict) else d
    ops = [e for e in evs if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    owners = launch_owners(evs)
    for e in ops:
        e["category"] = categorize(e, owners)
    return ops


def launch_owners(evs: list[dict]):
    """A function from a device event to the port kernel whose launch range
    issued it (or None): the host call that launched it (the runtime or
    driver event of the same correlation id) lies inside the range on its
    thread."""
    by_thread = collections.defaultdict(list)
    for e in evs:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(RANGE_PREFIX)):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}

    def owner(e: dict):
        call = calls.get(e.get("args", {}).get("correlation"))
        if call is None:
            return None
        inside = [r for r in by_thread[(call.get("pid"), call.get("tid"))]
                  if r["ts"] <= call["ts"] <= r["ts"] + r.get("dur", 0)]
        if not inside:
            return None
        return max(inside, key=lambda r: r["ts"])["name"][len(RANGE_PREFIX):]

    return owner


def categorize(e: dict, owner) -> str:
    entry = owner(e)
    if entry in PORT_KERNELS:
        return PORT_KERNELS[entry]
    name = e.get("name", "")
    for label, pattern in CATEGORIES:
        if pattern.search(name):
            return label
    return "other"


def family(name: str) -> str:
    """A kernel name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0] or name


def report(ops: list[dict], n_steps: int) -> dict:
    """Print the three sections; returns the device ms per step and per
    category."""
    by_cat = collections.defaultdict(lambda: [0, 0.0])
    by_fam = collections.defaultdict(lambda: [0, 0.0])
    total = 0.0
    for e in ops:
        dur = e.get("dur", 0.0)  # us
        total += dur
        c = by_cat[e["category"]]
        c[0] += 1
        c[1] += dur
        f = by_fam[(e["category"], family(e.get("name", "")))]
        f[0] += 1
        f[1] += dur
    print(f"H100 SXM peaks: {PEAK_BF16_TFLOPS:.0f} TFLOP/s dense bf16, {HBM_TBPS} TB/s HBM3")
    print(f"device total: {total / 1e3 / n_steps:.1f} ms/step "
          f"({len(ops)} kernel events / {n_steps} steps)")
    print("\n-- by category --")
    for cat, (n, dur) in sorted(by_cat.items(), key=lambda kv: -kv[1][1]):
        print(f"{dur / 1e3 / n_steps:8.2f} ms/step  x{n // n_steps:5d}  {cat}")
    print("\n-- top kernel families --")
    for (cat, fam), (n, dur) in sorted(by_fam.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"{dur / 1e3 / n_steps:8.2f} ms/step  x{n // n_steps:5d}  [{cat}] {fam[:70]}")
    print("\n-- top single kernels --")
    seen = set()
    for e in sorted(ops, key=lambda e: -e.get("dur", 0)):
        if e["name"] in seen:
            continue
        seen.add(e["name"])
        print(f"{e['dur'] / 1e3:8.3f} ms  [{e['category']}] {e['name'][:140]}")
        if len(seen) >= 20:
            break
    return dict(ms_per_step=total / 1e3 / n_steps, events=len(ops),
                categories={cat: dur / 1e3 / n_steps for cat, (_, dur) in by_cat.items()})


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    trace_dir = argv[0]
    n_steps = int(argv[1]) if len(argv) > 1 else 3
    return report(load_events(trace_dir), n_steps)


if __name__ == "__main__":
    main()
