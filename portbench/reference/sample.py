"""EDM's deterministic Heun sampler with classifier-free guidance, in plain
PyTorch (EDM, arXiv 2206.00364, Algorithm 1 with the time steps of Eq. 5).

  t_i = (s_max^(1/rho) + i / (n-1) (s_min^(1/rho) - s_max^(1/rho)))^rho, t_n = 0
  x_0 = latents * t_0
  d   = (x_i - D(x_i; t_i)) / t_i,  x' = x_i + (t_{i+1} - t_i) d
  x_{i+1} = x_i + (t_{i+1} - t_i) (d + (x' - D(x'; t_{i+1})) / t_{i+1}) / 2, but for the last step

The levels are formed in float64 and used in float32, the state is float32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.maskdit import denoise


def time_steps(num_steps: int, sigma_min: float, sigma_max: float, rho: float) -> np.ndarray:
    i = np.arange(num_steps, dtype=np.float64)
    t = (sigma_max ** (1 / rho) + i / (num_steps - 1)
         * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([t, [0.0]]).astype(np.float32)


@torch.no_grad()
def heun(P, cfg, latents, labels, mix, ops) -> torch.Tensor:
    """The sampled latents (N, C, H, W) of ``latents`` and one-hot ``labels``."""
    t = time_steps(mix["num_steps"], mix["sigma_min"], mix["sigma_max"], mix["rho"])
    scale = mix["cfg_scale"]

    def d_of(x, sigma):
        s = torch.full((x.shape[0],), float(sigma), device=x.device)
        return denoise(P, cfg, x, s, labels, None, ops, cfg_scale=scale)

    x = latents.float() * float(t[0])
    for i in range(mix["num_steps"]):
        t_cur, t_next = float(t[i]), float(t[i + 1])
        d = (x - d_of(x, t_cur)) / t_cur
        x_next = x + (t_next - t_cur) * d
        if i < mix["num_steps"] - 1:
            d2 = (x_next - d_of(x_next, t_next)) / t_next
            x_next = x + (t_next - t_cur) * (0.5 * d + 0.5 * d2)
        x = x_next
    return x
