"""Batch generation: seeds -> sampled latents -> files.

Counterpart of maskdit_tpu/sampling/generate.py (reference:
generate_with_net, sample.py:230-296). Per-seed determinism comes from
StackedRandomGenerator, and seeds are rank-strided (sample.py:232-235) so
any world size produces the same images. The port writes latents as
``.npy``; decoding them to PNGs waits for the VAE's port.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.sampling.edm import ablation_sampler, edm_sampler
from maskdit_tpu_torch.utils.rng import StackedRandomGenerator

VAE_NOT_PORTED = (
    "VAE decode is not ported to maskdit_tpu_torch yet (models/vae.py); "
    "write latents with --no_decode / save_latents=True"
)


@dataclass
class SamplerConfig:
    """Sampler options (reference CLI args, generate.py ~:320-340)."""

    num_steps: int = 40
    cfg_scale: Optional[float] = None
    S_churn: float = 0.0
    solver: Optional[str] = None
    discretization: Optional[str] = None
    schedule: Optional[str] = None
    scaling: Optional[str] = None
    extra: dict = field(default_factory=dict)

    @property
    def use_ablation(self) -> bool:
        return any(
            v is not None
            for v in (self.solver, self.discretization, self.schedule, self.scaling)
        )


def make_sample_fn(
    model: EDMPrecond, cfg: SamplerConfig,
) -> Callable[..., torch.Tensor]:
    """Build ``sample(latents, labels, generator=None) -> latents``.

    ``generator`` feeds the churn noise and is needed only with S_churn > 0.
    """
    kwargs: dict = {"num_steps": cfg.num_steps, "S_churn": cfg.S_churn}
    # noise levels the net supports (reference sample.py:36-37,104-106,157;
    # the identity for EDMPrecond)
    kwargs.update(
        net_sigma_min=model.sigma_min,
        net_sigma_max=model.sigma_max,
        round_sigma=model.round_sigma,
    )
    kwargs.update(cfg.extra)
    if cfg.use_ablation:
        kwargs.update(
            solver=cfg.solver or "heun",
            discretization=cfg.discretization or "edm",
            schedule=cfg.schedule or "linear",
            scaling=cfg.scaling or "none",
        )
        sampler = ablation_sampler
    else:
        sampler = edm_sampler

    @torch.no_grad()
    def sample(latents: torch.Tensor, labels: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def denoise(x: torch.Tensor, sigma: float) -> torch.Tensor:
            sig = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
            return model(x, sig, labels, cfg_scale=cfg.cfg_scale)["x"]

        return sampler(denoise, latents, generator=generator, **kwargs)

    return sample


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1,1] NCHW float -> uint8 NHWC (reference: sample.py:287)."""
    arr = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return arr.transpose(0, 2, 3, 1)


def save_images(
    images_np: np.ndarray, seeds: Sequence[int], outdir: str, subdirs: bool = False
) -> None:
    from PIL import Image

    for seed, image_np in zip(seeds, images_np):
        image_dir = (
            os.path.join(outdir, f"{seed - seed % 1000:06d}") if subdirs else outdir
        )
        os.makedirs(image_dir, exist_ok=True)
        path = os.path.join(image_dir, f"{seed:06d}.png")
        if image_np.shape[2] == 1:
            Image.fromarray(image_np[:, :, 0], "L").save(path)
        else:
            Image.fromarray(image_np, "RGB").save(path)


def generate_with_params(
    model: EDMPrecond,
    seeds: Sequence[int],
    outdir: Optional[str],
    sampler_cfg: SamplerConfig,
    class_idx: Optional[int] = None,
    max_batch_size: int = 50,
    rank: int = 0,
    world: int = 1,
    save_latents: bool = False,
) -> Optional[np.ndarray]:
    """Sample ``seeds`` with ``model`` (which carries its weights and device).

    Seed batching mirrors sample.py:232-235: equal batches, then
    rank-strided assignment. With ``outdir`` None the stacked latents are
    returned; otherwise each batch goes to
    ``outdir/latents_<first seed>.npy``, which needs ``save_latents``
    until the VAE is ported.
    """
    if outdir is not None and not save_latents:
        raise NotImplementedError(VAE_NOT_PORTED)
    device = next(model.parameters()).device
    seeds = list(seeds)
    num_batches = ((len(seeds) - 1) // (max_batch_size * world) + 1) * world
    all_batches = np.array_split(np.asarray(seeds), num_batches)
    sample_fn = make_sample_fn(model, sampler_cfg)
    res, ch = model.img_resolution, model.img_channels
    collected = []
    for batch_seeds in all_batches[rank::world]:
        if len(batch_seeds) == 0:
            continue
        g = StackedRandomGenerator(device, batch_seeds.tolist())
        latents = g.randn([len(batch_seeds), ch, res, res])
        if model.num_classes:
            labels_idx = g.randint(model.num_classes, size=[len(batch_seeds)])
            if class_idx is not None:
                labels_idx = torch.full_like(labels_idx, class_idx)
            labels = F.one_hot(labels_idx, model.num_classes).float()
        else:
            labels = torch.zeros((len(batch_seeds), 0), device=device)
        churn = None
        if sampler_cfg.S_churn > 0:
            churn = torch.Generator(device).manual_seed(int(batch_seeds[0]))
        z = sample_fn(latents, labels, churn).cpu().numpy()
        if outdir is None:
            collected.append(z)
        else:
            os.makedirs(outdir, exist_ok=True)
            np.save(os.path.join(outdir, f"latents_{int(batch_seeds[0]):06d}.npy"), z)
    if outdir is None and collected:
        return np.concatenate(collected)
    return None
