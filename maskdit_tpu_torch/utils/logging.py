"""Stdout tee, metric sink, throughput tracker and CLI value parsers.

The port's own copy of what it uses of maskdit_tpu/utils/logging.py (the
reference's Logger tee, utils.py:169-225, its int-list parser,
utils.py:140-152, and the JSONL metric sink with the reference's wandb
metric names), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Any, Optional


class Logger:
    """Tee stdout/stderr to a log file (reference: utils.py:169-225)."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "w",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MetricLogger:
    """JSONL + optional wandb metric sink with reference metric names."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None, config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self._path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(config=config, **(wandb_kwargs or {}))
            except Exception as e:  # wandb not installed / offline
                print(f"[metrics] wandb unavailable ({e}); using JSONL only",
                      file=sys.stderr)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


class Throughput:
    """steps/sec + images/sec since the last reset; the caller updates it
    after a synchronising log point."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._images = 0

    def update(self, steps: int = 1, images: int = 0) -> None:
        self._steps += steps
        self._images += images

    def rates(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "steps_per_sec": self._steps / dt,
            "images_per_sec": self._images / dt,
        }


def parse_int_list(s) -> list[int]:
    """'1,2,5-10' -> [1,2,5,...,10] (reference: utils.py:140-152)."""
    if isinstance(s, list):
        return s
    ranges = []
    range_re = re.compile(r"^(\d+)-(\d+)$")
    for p in str(s).split(","):
        m = range_re.match(p)
        if m:
            ranges.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ranges.append(int(p))
    return ranges


def parse_float_none(s):
    return None if s in (None, "None") else float(s)


def parse_str_none(s):
    return None if s in (None, "None") else str(s)


def str2bool(s) -> bool:
    if isinstance(s, bool):
        return s
    return str(s).lower() in ("true", "1", "yes")
