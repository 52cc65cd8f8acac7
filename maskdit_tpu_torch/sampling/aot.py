"""Ahead-of-time export of the sampler (the serving path).

Counterpart of maskdit_tpu/sampling/aot.py, which serialises the compiled
sampler with ``jax.export``. Here ``torch.export`` traces the whole sampler
for one (model, SamplerConfig, batch size), as ``make_sample_fn`` runs it:
every Heun step and CFG evaluation, unrolled (2 * num_steps - 1 evaluations
of the model), into one ATen graph saved with ``torch.export.save``. The
parameters are an input (a dict under the reference ``.pt`` keys), so the
file holds no weights; the fixed sin-cos tables are constants in it. The
attention kernels appear as the torch ops that ``maskdit_tpu_torch.ops``
registers (``maskdit_torch::packed_attention_fwd``,
``::packed_attention_big_fwd``, ``::flash_fwd``), so any process that
imports ``torch`` and ``maskdit_tpu_torch.ops`` runs the file without the
model code; on a card the ops launch (and count) the hand-written kernels,
on the CPU they run their plain versions:

    export_sampler(model, cfg, batch_size, path)
    sample = load_sampler(path)
    latents_out = sample(params, latents, labels[, churn_noise])

``load_sampler`` / ``LoadedSampler`` live in ``maskdit_tpu_torch.ops.exported``
(re-exported here), which imports nothing of the model or sampling code. A
graph takes no generator: with S_churn > 0 the program takes the churn noise
as an input, (num_steps, N, C, H, W), and ``LoadedSampler.churn_noise
(generator)`` draws it in the live sampler's order. As the JAX export, it
takes no ``feat`` (maskdit_tpu/sampling/aot.py:68-76): the model runs as it
does without one.
"""

from __future__ import annotations

import json
from typing import Optional

import torch
import torch.nn as nn

from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.ops.exported import META, LoadedSampler, load_sampler
from maskdit_tpu_torch.sampling.generate import SamplerConfig, sampler_of

__all__ = ["export_sampler", "load_sampler", "LoadedSampler"]


class _Sampler(nn.Module):
    """The sampler as a module whose forward takes the parameters. The model
    is kept in a list, outside the module's tree, so that none of its
    weights is lifted into the program."""

    def __init__(self, model: EDMPrecond, cfg: SamplerConfig):
        super().__init__()
        self._model = [model]
        self.sampler, self.kwargs = sampler_of(model, cfg)
        self.cfg_scale = cfg.cfg_scale

    def forward(self, params: dict, latents: torch.Tensor, labels: torch.Tensor,
                churn_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        model = self._model[0]

        def denoise(x: torch.Tensor, sigma: float) -> torch.Tensor:
            sig = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
            return torch.func.functional_call(model, params, (x, sig, labels),
                                              {"cfg_scale": self.cfg_scale})["x"]

        return self.sampler(denoise, latents, churn_noise=churn_noise, **self.kwargs)


def export_sampler(model: EDMPrecond, cfg: SamplerConfig, batch_size: int,
                   path: Optional[str] = None) -> torch.export.ExportedProgram:
    """The sampler of ``model`` (on its device, in its compute dtype) for
    ``cfg`` at ``batch_size``, exported; written to ``path`` where given."""
    device = next(model.parameters()).device
    params = {k: v.detach() for k, v in model.named_parameters()}
    shape = (batch_size, model.img_channels, model.img_resolution, model.img_resolution)
    args = [params, torch.zeros(shape, device=device),
            torch.zeros((batch_size, model.num_classes), device=device)]
    if cfg.S_churn > 0:
        args.append(torch.zeros((cfg.num_steps, *shape), device=device))
    with torch.no_grad():
        program = torch.export.export(_Sampler(model, cfg), tuple(args), strict=False)
    program.example_inputs = None  # they hold the weights
    if path is not None:
        meta = dict(shape=list(shape), num_classes=model.num_classes,
                    num_steps=cfg.num_steps, S_churn=cfg.S_churn, cfg_scale=cfg.cfg_scale,
                    device=str(device), param_names=list(params))
        torch.export.save(program, path, extra_files={META: json.dumps(meta)})
    return program
