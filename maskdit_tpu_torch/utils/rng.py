"""Per-seed random generators for reproducible batched sampling.

Counterpart of maskdit_tpu/utils/rng.py, and the reference's own
StackedRandomGenerator (utils.py:119-133): one ``torch.Generator`` per
seed, so a sample depends only on its seed, never on the rest of its batch
or on the rank that draws it. The streams differ from JAX's threefry; the
contract kept is the independence, not the numbers.
"""

from __future__ import annotations

from typing import Sequence

import torch


class StackedRandomGenerator:
    def __init__(self, device: torch.device | str, seeds: Sequence[int]):
        self.device = torch.device(device)
        self.generators = [
            torch.Generator(self.device).manual_seed(int(seed) % (1 << 32))
            for seed in seeds
        ]

    def randn(self, size: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Normal draws of shape ``size``; size[0] must be the batch size."""
        if size[0] != len(self.generators):
            raise ValueError(f"size {tuple(size)} vs {len(self.generators)} seeds")
        return torch.stack([
            torch.randn(tuple(size[1:]), generator=g, dtype=dtype, device=self.device)
            for g in self.generators
        ])

    def randint(self, high: int, size: Sequence[int]) -> torch.Tensor:
        """Integers in [0, high) of shape ``size``; size[0] is the batch size."""
        if size[0] != len(self.generators):
            raise ValueError(f"size {tuple(size)} vs {len(self.generators)} seeds")
        return torch.stack([
            torch.randint(high, tuple(size[1:]), generator=g, device=self.device)
            for g in self.generators
        ])
