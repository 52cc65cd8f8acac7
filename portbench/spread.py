"""Run cells several times, one process per run, and report each metric's
spread: the distance between the first and third quartiles (Python's
``statistics.quantiles(values, n=4)``) over the median.

    python3 portbench/spread.py --workload train256 --seeds 11,12,13 \
        [--seconds 35] [--trace 0] [--out DIR]

Each run's last line goes to ``<out>/<workload>.jsonl`` with its seed and
exit code; the summary is printed at the end. ``--seconds`` defaults to
BENCHMARK.json's ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=str(ROOT / "build" / "portbench" / "spread"))
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rc = 0
    for workload in args.workload:
        lines = []
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", workload,
                 "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            last = proc.stdout.strip().splitlines()[-1:] or [""]
            try:
                line = json.loads(last[0])
            except json.JSONDecodeError:
                line = None
            record = {"workload": workload, "seed": seed, "rc": proc.returncode, "wall_s": wall,
                      "line": line}
            if line is None:
                record["stderr"] = proc.stderr[-3000:]
                rc = 1
            with open(out / f"{workload}.jsonl", "a") as f:
                f.write(json.dumps(record) + "\n")
            print(json.dumps(record)[:3000], flush=True)
            if line is not None:
                lines.append(line)
        values: dict[str, list[float]] = {}
        for line in lines:
            for name, m in line["metrics"].items():
                values.setdefault(name, []).append(m["value"])
        for name, vs in sorted(values.items()):
            print(f"SPREAD {workload} {name} n={len(vs)} median={statistics.median(vs)!r} "
                  f"spread={spread(vs)!r} values={vs!r}", flush=True)
        print(f"CORRECT {workload} {[line['correct'] for line in lines]}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
