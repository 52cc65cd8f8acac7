"""MaskDiT's training step in plain PyTorch, from the equations.

One step (MaskDiT, arXiv 2306.09305, Sec. 3; EDM, arXiv 2206.00364, Sec. 5):
  z     = scale * (mean + exp(logvar / 2) * eps)       the VAE moments' sample
  y     = one_hot * [u >= p_drop]                       label dropout for CFG
  n     = sigma * noise
  D     = denoiser(z + n; sigma, y), the encoder on the kept patches only
  dsm   = mean over kept patches of mean_c,pxp [ (sigma^2 + sd^2) / (sigma sd)^2 (D - z)^2 ]
  mae   = mean over dropped patches of mean [ (patch(D) - norm(patch(z + n)))^2 ],
          norm: each patch less its mean over its values, over sqrt(unbiased var + 1e-6)
  loss  = mean over the batch of dsm + mae_coef * mae
then Adam (bias-corrected, eps outside the square root) and the EMA of the
new parameters. The gradient of the batch's mean is summed over blocks of
rows, so that activations fit.
"""

from __future__ import annotations

import torch

from portbench.reference.maskdit import denoise


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    n, c, hh, ww = x.shape
    g = hh // p
    return x.reshape(n, c, g, p, g, p).permute(0, 2, 4, 3, 5, 1).reshape(n, g * g, p * p * c)


def row_losses(P, cfg, feed, ops) -> torch.Tensor:
    """Each row's loss (N,) for one feed: moments, one-hot labels and the
    step's draws (``z_noise``, ``drop_u``, ``sigma``, ``noise``,
    ``ids_keep``)."""
    p, sd = cfg["patch_size"], cfg["sigma_data"]
    mean, logvar = feed["moments"].chunk(2, dim=1)
    z = cfg["scale_factor"] * (mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
                               * feed["z_noise"])
    y = feed["labels"] * (feed["drop_u"] >= cfg["class_dropout_prob"]).float()
    sigma = feed["sigma"].reshape(-1, 1, 1, 1)
    noisy = z + sigma * feed["noise"]
    ids_keep = feed["ids_keep"]
    d = denoise(P, cfg, noisy, feed["sigma"], y, ids_keep, ops)
    n, c, hh, ww = z.shape
    weight = (sigma ** 2 + sd ** 2) / (sigma * sd) ** 2
    per_px = (weight * (d - z) ** 2).mean(dim=1)  # (N, H, W)
    per_patch = per_px.reshape(n, hh // p, p, ww // p, p).mean(dim=(2, 4)).reshape(n, -1)
    keep = torch.zeros_like(per_patch).scatter(1, ids_keep, 1.0)
    loss = (per_patch * keep).sum(1) / keep.sum(1)
    if cfg["mae_loss_coef"] > 0:
        target = _patches(noisy, p)
        target = (target - target.mean(-1, keepdim=True)) / torch.sqrt(
            target.var(-1, keepdim=True, unbiased=True) + 1e-6)
        mae = ((_patches(d, p) - target) ** 2).mean(-1)
        drop = 1.0 - keep
        loss = loss + cfg["mae_loss_coef"] * (mae * drop).sum(1) / drop.sum(1)
    return loss


def leaf_norms(tensors) -> list[float]:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).double().tolist()


def run_steps(params0: dict, cfg: dict, opt: dict, feeds: list, ops, rows: int) -> dict:
    """Train from ``params0`` (fp32, by name) over ``feeds``, one step
    each. Returns each step's loss, each leaf's gradient norm at the first
    step, and each leaf's change of the parameters and of the EMA after the
    last step, by name."""
    names = list(params0)
    params = [params0[k].detach().clone().requires_grad_(True) for k in names]
    ema = [t.detach().clone() for t in params]
    m = [torch.zeros_like(t) for t in params]
    v = [torch.zeros_like(t) for t in params]
    b1, b2, eps, lr, decay = opt["b1"], opt["b2"], opt["eps"], opt["lr"], opt["ema_decay"]
    losses, grad_norms = [], None
    for step, feed in enumerate(feeds, start=1):
        n = feed["moments"].shape[0]
        P = dict(zip(names, params))
        total = 0.0
        for lo in range(0, n, rows):
            part = {k: t[lo:lo + rows] for k, t in feed.items()}
            chunk = row_losses(P, cfg, part, ops).sum() / n
            chunk.backward()
            total += chunk.item()
        losses.append(total)
        grads = [t.grad for t in params]
        if grad_norms is None:
            grad_norms = leaf_norms(grads)
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for t, g, mt, vt, et in zip(params, grads, m, v, ema):
                mt.mul_(b1).add_((1 - b1) * g)
                vt.mul_(b2).add_((1 - b2) * g * g)
                t.sub_(lr * (mt / bc1) / (torch.sqrt(vt / bc2) + eps))
                et.mul_(decay).add_((1 - decay) * t)
                t.grad = None
    with torch.no_grad():
        change = leaf_norms(t - params0[k] for k, t in zip(names, params))
        ema_change = leaf_norms(e - params0[k] for k, e in zip(names, ema))
    return {
        "losses": losses,
        "grad_norms": dict(zip(names, grad_norms)),
        "change_norms": dict(zip(names, change)),
        "ema_change_norms": dict(zip(names, ema_change)),
    }
