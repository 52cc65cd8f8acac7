"""EDM denoising loss with per-patch masking and the MAE auxiliary loss.

Counterpart of maskdit_tpu/train/loss.py (reference: train_utils/loss.py:
22-101). Per sample:
  sigma ~ exp(N(P_mean, P_std)); weight = (sigma^2 + sd^2) / (sigma*sd)^2
  loss  = weight * ||D(y + n; sigma) - y||^2,
averaged per patch over the *unmasked* patches, plus ``mae_loss_coef``
times a pixel-normalised MAE loss on the *masked* patches, whose target is
the noisy input y + n (loss.py:150).

The loss draws sigma, the noise and the mask (in that order) from one
``torch.Generator``; each can be injected instead, so a test can feed the
values the JAX package drew.
"""

from __future__ import annotations

from typing import Optional

import torch

from maskdit_tpu_torch.models.masking import MaskInfo, random_mask


def patchify(imgs: torch.Tensor, patch_size: int = 2) -> torch.Tensor:
    """(N, C, H, W) -> (N, L, p*p*C), intra-patch order (ph, pw, c)
    (reference: loss.py:73-85)."""
    n, c, hh, ww = imgs.shape
    p = patch_size
    if hh != ww or hh % p:
        raise ValueError(f"image {hh}x{ww} is not square or not divisible by {p}")
    h = w = hh // p
    x = imgs.reshape(n, c, h, p, w, p)
    x = torch.einsum("nchpwq->nhwpqc", x)
    return x.reshape(n, h * w, p * p * c)


def per_patch_mean(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Channel mean, then the p x p average pool, flattened to (N, L) in
    row-major patch order (the reference's avg_pool2d, loss.py:45)."""
    n, _, hh, ww = x.shape
    p = patch_size
    xm = x.mean(dim=1)
    xm = xm.reshape(n, hh // p, p, ww // p, p).mean(dim=(2, 4))
    return xm.reshape(n, -1)


def mae_loss(
    target: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor,
    patch_size: int, norm_pix_loss: bool = True,
) -> torch.Tensor:
    """Mean per-patch MSE over the masked patches (mask == 1), per sample
    (reference: loss.py:88-101). With ``norm_pix_loss`` each target patch
    is standardised with the unbiased variance, 1e-6 inside the sqrt."""
    target = patchify(target, patch_size)
    pred = patchify(pred, patch_size)
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=1)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    loss = (pred - target).square().mean(dim=-1)
    return (loss * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


class EDMLoss:
    """The reference's Losses['edm'] (loss.py:22-60)."""

    def __init__(self, P_mean: float = -1.2, P_std: float = 1.2, sigma_data: float = 0.5):
        self.P_mean = P_mean
        self.P_std = P_std
        self.sigma_data = sigma_data

    def __call__(
        self,
        net,
        images: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        mask_ratio: float = 0.0,
        mae_loss_coef: float = 0.0,
        patch_size: int = 2,
        generator: Optional[torch.Generator] = None,
        sigma: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        mask_info: Optional[MaskInfo] = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Returns (per-sample loss (N,), aux dict).

        ``net`` is an EDMPrecond. ``sigma`` is (N,) noise levels and
        ``noise`` (N, C, H, W) unit normals (scaled by sigma here); either,
        and ``mask_info``, replace the draw from ``generator``.
        """
        n = images.shape[0]
        device = images.device
        if sigma is None:
            rnd_normal = torch.randn((n, 1, 1, 1), generator=generator, device=device)
            sigma = torch.exp(rnd_normal * self.P_std + self.P_mean)
        sigma = sigma.float().reshape(n, 1, 1, 1)
        weight = (sigma ** 2 + self.sigma_data ** 2) / (sigma * self.sigma_data) ** 2

        y = images.float()
        if noise is None:
            noise = torch.randn(y.shape, generator=generator, device=device)
        noise = noise.float() * sigma

        masked = float(mask_ratio) > 0
        if masked and mask_info is None:
            n_tokens = (y.shape[2] // patch_size) * (y.shape[3] // patch_size)
            mask_info = random_mask(n, n_tokens, mask_ratio, generator, device=device)

        model_out = net(
            y + noise, sigma.reshape(-1), labels, mask_ratio=float(mask_ratio),
            mask_info=mask_info, train=True,
        )
        d_yn = model_out["x"].float()
        loss_px = weight * (d_yn - y).square()

        aux = {"sigma_mean": sigma.mean()}
        if masked:
            loss_patch = per_patch_mean(loss_px, patch_size)
            unmask = 1.0 - model_out["mask"]
            loss_vec = (loss_patch * unmask).sum(dim=1) / unmask.sum(dim=1).clamp_min(1.0)
            aux["dsm_loss"] = loss_vec.mean()
            if mae_loss_coef > 0:
                mae = mae_loss(y + noise, d_yn, 1.0 - unmask, patch_size)
                aux["mae_loss"] = mae.mean()
                loss_vec = loss_vec + mae_loss_coef * mae
        else:
            loss_vec = loss_px.mean(dim=(1, 2, 3))
            aux["dsm_loss"] = loss_vec.mean()
        return loss_vec, aux


LOSSES = {"edm": EDMLoss}
