"""An exported sampler read back (``sampling/aot.export_sampler``'s file).

This module imports ``torch`` and this package only: the package registers
the forward kernels #1, #3 and #5 as torch ops, and the file calls them, so
a process that serves an exported sampler needs nothing of the model or
sampling code:

    from maskdit_tpu_torch.ops.exported import load_sampler
    sample = load_sampler(path)
    latents_out = sample(params, latents, labels[, churn_noise])

``params`` maps the reference ``.pt`` keys to tensors (the file lists the
ones it takes). A graph takes no generator: with S_churn > 0 the program
takes the churn noise as an input, (num_steps, N, C, H, W), and
``LoadedSampler.churn_noise(generator)`` draws it in the live sampler's
order, on the device the file was exported on.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

META = "sampler.json"  # the export's settings, beside the program in the file


class LoadedSampler:
    """An exported sampler read back: ``sample(params, latents, labels,
    churn_noise=None) -> latents``; ``meta`` holds the export's settings."""

    def __init__(self, path: str):
        extra = {META: ""}
        self.program = torch.export.load(path, extra_files=extra)
        self.meta = json.loads(extra[META])
        self._run = self.program.module()

    def __call__(self, params: dict, latents: torch.Tensor, labels: torch.Tensor,
                 churn_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        args = [{k: params[k] for k in self.meta["param_names"]}, latents, labels]
        if (churn_noise is None) == (self.meta["S_churn"] > 0):
            raise ValueError(f"exported with S_churn={self.meta['S_churn']}: churn_noise "
                             f"{'is needed' if churn_noise is None else 'is not taken'} "
                             "(LoadedSampler.churn_noise draws it)")
        if churn_noise is not None:
            args.append(churn_noise)
        with torch.no_grad():
            return self._run(*args)

    def churn_noise(self, generator: torch.Generator) -> torch.Tensor:
        """The churn noise the live sampler (``sampling/edm``: one fp32 draw
        of the latents' shape per step) draws from ``generator`` for this
        export's steps and batch, stacked to (num_steps, *shape), on the
        export's device, where ``generator`` must live (a card's live
        sampler draws with a CUDA generator)."""
        return torch.stack([torch.randn(tuple(self.meta["shape"]), generator=generator,
                                        dtype=torch.float32, device=self.meta["device"])
                            for _ in range(self.meta["num_steps"])])


def load_sampler(path: str) -> LoadedSampler:
    """Read a file of ``sampling/aot.export_sampler``."""
    return LoadedSampler(path)
