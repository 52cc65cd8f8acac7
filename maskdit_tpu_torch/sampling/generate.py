"""Batch generation: seeds -> sampled latents -> decoded PNGs (or latents).

Counterpart of maskdit_tpu/sampling/generate.py (reference:
generate_with_net, sample.py:230-296). Per-seed determinism comes from
StackedRandomGenerator, and seeds are rank-strided (sample.py:232-235) so
any world size produces the same images. With a VAE each batch is decoded
(halving the batch where the device runs out of memory, as the reference's
recur_decode does) and written as ``{seed:06d}.png`` through the port's own
PNG codec; without one the latents go to ``.npy`` files.
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
from maskdit_tpu_torch.utils.png import write_png
from maskdit_tpu_torch.utils.rng import StackedRandomGenerator


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


def decode_images(vae, z: torch.Tensor, max_split: int = 4) -> np.ndarray:
    """``vae.decode(z)`` as a numpy array. Where the device runs out of
    memory the batch is decoded again in 2, 4, ... parts, up to
    ``2 ** max_split`` (reference recur_decode; the JAX package's
    ``decode_images``); any other error propagates at once."""
    for split in range(max_split + 1):
        parts = min(2 ** split, z.shape[0])
        try:
            return torch.cat([vae.decode(part).cpu() for part in z.tensor_split(parts)]).numpy()
        except torch.cuda.OutOfMemoryError:
            if split == max_split or parts == z.shape[0]:
                raise
    raise AssertionError("unreachable")


def to_uint8(images: np.ndarray) -> np.ndarray:
    """[-1,1] NCHW float -> uint8 NHWC (reference: sample.py:287)."""
    arr = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return arr.transpose(0, 2, 3, 1)


def save_images(
    images_np: np.ndarray, seeds: Sequence[int], outdir: str, subdirs: bool = False
) -> None:
    """uint8 NHWC images -> ``{seed:06d}.png`` (gray or RGB), under
    thousand-seed subdirectories with ``subdirs``."""
    for seed, image_np in zip(seeds, images_np):
        image_dir = (
            os.path.join(outdir, f"{seed - seed % 1000:06d}") if subdirs else outdir
        )
        os.makedirs(image_dir, exist_ok=True)
        write_png(os.path.join(image_dir, f"{seed:06d}.png"), image_np)


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
    vae=None,
) -> Optional[np.ndarray]:
    """Sample ``seeds`` with ``model`` (which carries its weights and device).

    Seed batching mirrors sample.py:232-235: equal batches, then
    rank-strided assignment. With a ``vae`` (an ``AutoencoderKL`` on the
    model's device) each batch is decoded and, with ``outdir``, written as
    ``{seed:06d}.png``; without one the batch's latents go to
    ``outdir/latents_<first seed>.npy``, which needs ``save_latents``. With
    ``outdir`` None the stacked uint8 NHWC images (or the latents) are
    returned.
    """
    if outdir is not None and vae is None and not save_latents:
        raise ValueError("need a VAE to write PNGs; pass vae, or save_latents=True")
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
        z = sample_fn(latents, labels, churn)
        out = to_uint8(decode_images(vae, z)) if vae is not None else z.cpu().numpy()
        if outdir is None:
            collected.append(out)
        elif vae is not None:
            save_images(out, batch_seeds.tolist(), outdir)
        else:
            os.makedirs(outdir, exist_ok=True)
            np.save(os.path.join(outdir, f"latents_{int(batch_seeds[0]):06d}.npy"), out)
    if outdir is None and collected:
        return np.concatenate(collected)
    return None
