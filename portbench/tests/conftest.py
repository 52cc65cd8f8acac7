"""Fixtures of the benchmark's CPU tests: a checkout-like root holding a copy
of ``portbench/`` and ``BENCHMARK.json`` plus tiny cells.

The tiny cells run the port's real entry points at a DiT of 2 blocks of
width 32 (registered as ``DiT-T/2`` for the test) with a decoder of 2
blocks of width 16, on 8 x 8 latents, with the limits of the full-size
cells they stand for.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TINY = dict(model_type="DiT-T/2", depth=2, hidden_size=32, num_heads=2, decoder_depth=2,
            decoder_hidden_size=16, decoder_num_heads=2, in_size=8, num_classes=10)
TINY_CELLS = {  # cell: (mix it copies, its changes, the cell whose limits it takes)
    "tiny-train": ("train-mask0.5-b128", dict(batch=4, reference_rows=2), "train256"),
    "tiny-sample": ("sample-heun40-cfg1.5-b64", dict(batch=3, num_steps=4, compare_images=2,
                                                     denoise_steps=[0, 2]), "sample256"),
}


def patch_tiny_model(mp: pytest.MonkeyPatch) -> None:
    """The port's registry gets ``DiT-T/2`` and a decoder of 2 x 16 at 2 heads."""
    from maskdit_tpu_torch.models import dit

    mp.setitem(dit.DIT_CONFIGS, "DiT-T/2", dict(depth=2, hidden_size=32, patch_size=2,
                                                num_heads=2))
    mp.setattr(dit, "DECODER_HIDDEN_SIZE", 16)
    mp.setattr(dit, "DECODER_DEPTH", 2)
    mp.setattr(dit, "DECODER_NUM_HEADS", 2)


def make_root(tmp: Path, compute_dtype: str = "bfloat16") -> Path:
    """A copy of the benchmark with the tiny cells added as files and
    entries only."""
    shutil.copytree(REPO / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    here = tmp / "portbench"
    cfg = json.loads((here / "configs" / "maskdit-xl2-256.json").read_text())
    cfg.update(TINY, compute_dtype=compute_dtype)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2306.09305",
                             "file": "portbench/configs/tiny.json", "reduced": ["depth"],
                             "why": "a tiny MaskDiT for CPU tests"})
    for cell, (mix_name, changes, limits_of) in TINY_CELLS.items():
        mix = json.loads((here / "mixes" / f"{mix_name}.json").read_text())
        mix.update(changes)
        (here / "mixes" / f"{cell}.json").write_text(json.dumps(mix))
        shutil.copy(here / "limits" / f"{limits_of}.json", here / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": cell, "chips": 1,
                                   "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if limits_of in m.get("workloads", ()):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    patch_tiny_model(monkeypatch)
    return make_root(tmp_path)
