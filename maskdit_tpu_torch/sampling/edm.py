"""EDM samplers as Python loops over tensors.

Counterpart of maskdit_tpu/sampling/edm.py (reference sample.py:30-66,
edm_sampler, EDM Algorithm 2 / Heun; sample.py:73-188, the ablation
sampler superset). Noise levels are computed on the host in float64 and
rounded to float32, the ODE state is a float32 tensor, and every per-step
scalar is a numpy float32 on the host, so the loop does the JAX version's
float32 arithmetic and never waits for the device.

The denoiser is passed as ``denoise_fn(x, sigma) -> D_x`` with sigma a
Python float; CFG and weights are bound by the caller (sampling.generate).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, float], torch.Tensor]

f32 = np.float32


def _apply_net_sigma_surface(
    sigma_steps: np.ndarray, round_sigma: Optional[Callable],
) -> np.ndarray:
    """Route host-side noise levels through the net's ``round_sigma``
    (reference sample.py:43,157); the identity for EDMPrecond."""
    if round_sigma is None:
        return sigma_steps
    return np.asarray(round_sigma(sigma_steps), dtype=np.float64)


def edm_sigma_steps(
    num_steps: int, sigma_min: float = 0.002, sigma_max: float = 80.0,
    rho: float = 7.0,
) -> np.ndarray:
    """rho-spaced noise levels with terminal 0 (reference: sample.py:39-43)."""
    idx = np.arange(num_steps, dtype=np.float64)
    steps = (
        sigma_max ** (1 / rho)
        + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
    ) ** rho
    return np.concatenate([steps, np.zeros(1)])


def _churn_noise(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None:
        raise ValueError("S_churn > 0 requires a generator")
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def _step_noise(x: torch.Tensor, generator: Optional[torch.Generator],
                churn_noise: Optional[torch.Tensor], i: int) -> torch.Tensor:
    """Step ``i``'s churn noise: ``churn_noise[i]`` where the caller drew
    them (an exported sampler takes no generator), else a draw from
    ``generator``."""
    return churn_noise[i] if churn_noise is not None else _churn_noise(x, generator)


def edm_sampler(
    denoise_fn: DenoiseFn,
    latents: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    net_sigma_min: float = 0.0,
    net_sigma_max: float = float("inf"),
    round_sigma: Optional[Callable] = None,
    churn_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Heun 2nd-order EDM sampler (reference: sample.py:30-66).

    2 * num_steps - 1 denoiser evaluations: Heun on every step but the last.
    ``net_sigma_min/max`` clamp the range to what the net supports and
    ``round_sigma`` snaps levels to its grid (reference sample.py:36-37,43);
    both are the identity for EDMPrecond. With S_churn > 0 the churn noise
    comes from ``generator``, or from ``churn_noise`` (num_steps, *latents'
    shape), where given.
    """
    sigma_min = max(sigma_min, net_sigma_min)
    sigma_max = min(sigma_max, net_sigma_max)
    levels = edm_sigma_steps(num_steps, sigma_min, sigma_max, rho)
    levels[:-1] = _apply_net_sigma_surface(levels[:-1], round_sigma)
    t_steps = levels.astype(np.float32)
    gamma_max = min(S_churn / num_steps, math.sqrt(2.0) - 1.0)

    x_next = latents.float() * float(t_steps[0])
    for i in range(num_steps):
        x_cur = x_next
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        if S_churn > 0:
            gamma = f32(gamma_max) if S_min <= t_cur <= S_max else f32(0.0)
            t_hat = t_cur + gamma * t_cur
            coef = np.sqrt(np.maximum(t_hat ** 2 - t_cur ** 2, f32(0.0))) * f32(S_noise)
            x_hat = x_cur + float(coef) * _step_noise(x_cur, generator, churn_noise, i)
        else:
            t_hat = t_cur
            x_hat = x_cur

        denoised = denoise_fn(x_hat, float(t_hat)).float()
        d_cur = (x_hat - denoised) / float(t_hat)
        x_next = x_hat + float(t_next - t_hat) * d_cur
        if i < num_steps - 1:
            denoised = denoise_fn(x_next, float(t_next)).float()
            d_prime = (x_next - denoised) / float(t_next)
            x_next = x_hat + float(t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
    return x_next


# ---------------------------------------------------------------------------
# Ablation sampler (reference: sample.py:73-188)
# ---------------------------------------------------------------------------

def _vp_sigma(beta_d: float, beta_min: float):
    return lambda t: np.sqrt(np.expm1(0.5 * beta_d * t ** 2 + beta_min * t))


def ablation_sigma_steps(
    num_steps: int,
    discretization: str,
    sigma_min: Optional[float],
    sigma_max: Optional[float],
    rho: float = 7.0,
    epsilon_s: float = 1e-3,
    C_1: float = 0.001,
    C_2: float = 0.008,
    M: int = 1000,
    net_sigma_min: float = 0.0,
    net_sigma_max: float = float("inf"),
) -> tuple[np.ndarray, float, float]:
    """Host-side noise-level discretization for the ablation sampler.

    Returns (sigma_steps[num_steps], sigma_min, sigma_max): defaults
    resolved per discretization as in reference sample.py:97-103, then
    clamped to the net's supported range (sample.py:104-106).
    """
    if sigma_min is None:
        vp_def = _vp_sigma(19.1, 0.1)(epsilon_s)
        sigma_min = {"vp": vp_def, "ve": 0.02, "iddpm": 0.002, "edm": 0.002}[
            discretization
        ]
    if sigma_max is None:
        vp_def = _vp_sigma(19.1, 0.1)(1.0)
        sigma_max = {"vp": vp_def, "ve": 100.0, "iddpm": 81.0, "edm": 80.0}[
            discretization
        ]
    sigma_min = max(sigma_min, net_sigma_min)
    sigma_max = min(sigma_max, net_sigma_max)

    idx = np.arange(num_steps, dtype=np.float64)
    if discretization == "vp":
        vp_beta_d = (
            2
            * (np.log(sigma_min ** 2 + 1) / epsilon_s - np.log(sigma_max ** 2 + 1))
            / (epsilon_s - 1)
        )
        vp_beta_min = np.log(sigma_max ** 2 + 1) - 0.5 * vp_beta_d
        orig_t = 1 + idx / (num_steps - 1) * (epsilon_s - 1)
        sigma_steps = _vp_sigma(vp_beta_d, vp_beta_min)(orig_t)
    elif discretization == "ve":
        orig_t = sigma_max ** 2 * (sigma_min ** 2 / sigma_max ** 2) ** (
            idx / (num_steps - 1)
        )
        sigma_steps = np.sqrt(orig_t)
    elif discretization == "iddpm":
        u = np.zeros(M + 1, dtype=np.float64)
        alpha_bar = lambda j: np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2
        for j in range(M, 0, -1):
            u[j - 1] = np.sqrt(
                (u[j] ** 2 + 1)
                / max(alpha_bar(j - 1) / alpha_bar(j), C_1)
                - 1
            )
        u_filtered = u[(u >= sigma_min) & (u <= sigma_max)]
        pick = np.round(
            (len(u_filtered) - 1) / (num_steps - 1) * idx
        ).astype(np.int64)
        sigma_steps = u_filtered[pick]
    elif discretization == "edm":
        sigma_steps = (
            sigma_max ** (1 / rho)
            + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))
        ) ** rho
    else:
        raise ValueError(f"unknown discretization '{discretization}'")
    return sigma_steps, float(sigma_min), float(sigma_max)


def ablation_sampler(
    denoise_fn: DenoiseFn,
    latents: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_steps: int = 18,
    sigma_min: Optional[float] = None,
    sigma_max: Optional[float] = None,
    rho: float = 7.0,
    solver: str = "heun",
    discretization: str = "edm",
    schedule: str = "linear",
    scaling: str = "none",
    epsilon_s: float = 1e-3,
    C_1: float = 0.001,
    C_2: float = 0.008,
    M: int = 1000,
    alpha: float = 1.0,
    S_churn: float = 0.0,
    S_min: float = 0.0,
    S_max: float = float("inf"),
    S_noise: float = 1.0,
    net_sigma_min: float = 0.0,
    net_sigma_max: float = float("inf"),
    round_sigma: Optional[Callable] = None,
    churn_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generalized sampler superset (reference: sample.py:73-188).

    The schedule sigma(t), its derivative and inverse, and the scaling s(t)
    are evaluated on host float32 scalars; only the state update touches
    the device. The churn noise as ``edm_sampler`` takes it.
    """
    if solver not in ("euler", "heun"):
        raise ValueError(f"unknown solver '{solver}'")
    if discretization not in ("vp", "ve", "iddpm", "edm"):
        raise ValueError(f"unknown discretization '{discretization}'")
    if schedule not in ("vp", "ve", "linear"):
        raise ValueError(f"unknown schedule '{schedule}'")
    if scaling not in ("vp", "none"):
        raise ValueError(f"unknown scaling '{scaling}'")

    sigma_steps, sigma_min, sigma_max = ablation_sigma_steps(
        num_steps, discretization, sigma_min, sigma_max, rho, epsilon_s, C_1, C_2, M,
        net_sigma_min=net_sigma_min, net_sigma_max=net_sigma_max,
    )
    sigma_steps = _apply_net_sigma_surface(sigma_steps, round_sigma)

    vp_beta_d = float(
        2
        * (np.log(sigma_min ** 2 + 1) / epsilon_s - np.log(sigma_max ** 2 + 1))
        / (epsilon_s - 1)
    )
    vp_beta_min = float(np.log(sigma_max ** 2 + 1) - 0.5 * vp_beta_d)
    # host constants fold in float64 and meet the float32 state rounded,
    # as in the JAX version
    bd, bm = f32(vp_beta_d), f32(vp_beta_min)
    half_bd, two_bd, bm_sq = f32(0.5 * vp_beta_d), f32(2 * vp_beta_d), f32(vp_beta_min ** 2)

    if schedule == "vp":
        sigma = lambda t: np.sqrt(np.expm1(half_bd * t ** 2 + bm * t))
        sigma_deriv = lambda t: 0.5 * (bm + bd * t) * (sigma(t) + 1.0 / sigma(t))
        sigma_inv = lambda s: (np.sqrt(bm_sq + two_bd * np.log(s ** 2 + 1)) - bm) / bd
    elif schedule == "ve":
        sigma = lambda t: np.sqrt(t)
        sigma_deriv = lambda t: 0.5 / np.sqrt(t)
        sigma_inv = lambda s: s ** 2
    else:
        sigma = lambda t: t
        sigma_deriv = lambda t: np.ones_like(t)
        sigma_inv = lambda s: s

    if scaling == "vp":
        s_fn = lambda t: 1.0 / np.sqrt(1.0 + sigma(t) ** 2)
        s_deriv = lambda t: -sigma(t) * sigma_deriv(t) * s_fn(t) ** 3
    else:
        s_fn = lambda t: np.ones_like(t)
        s_deriv = lambda t: np.zeros_like(t)

    t_steps = sigma_inv(sigma_steps.astype(np.float32))
    t_steps = np.concatenate([t_steps, np.zeros(1, np.float32)])

    gamma_max = min(S_churn / num_steps, math.sqrt(2.0) - 1.0)

    def slope(x: torch.Tensor, t, denoised: torch.Tensor) -> torch.Tensor:
        """dx/dt = (sigma'/sigma + s'/s) x - sigma' s / sigma * D."""
        return float(sigma_deriv(t) / sigma(t) + s_deriv(t) / s_fn(t)) * x - float(
            sigma_deriv(t) * s_fn(t) / sigma(t)
        ) * denoised

    t0 = t_steps[0]
    x_next = latents.float() * float(sigma(t0) * s_fn(t0))
    for i in range(num_steps):
        x_cur = x_next
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        if S_churn > 0:
            in_range = S_min <= sigma(t_cur) <= S_max
            gamma = f32(gamma_max) if in_range else f32(0.0)
            t_hat = sigma_inv(sigma(t_cur) + gamma * sigma(t_cur))
            coef = (
                np.sqrt(np.maximum(sigma(t_hat) ** 2 - sigma(t_cur) ** 2, f32(0.0)))
                * s_fn(t_hat) * f32(S_noise)
            )
            x_hat = float(s_fn(t_hat) / s_fn(t_cur)) * x_cur + float(coef) * _step_noise(
                x_cur, generator, churn_noise, i
            )
        else:
            t_hat = t_cur
            x_hat = x_cur

        h = t_next - t_hat
        denoised = denoise_fn(x_hat / float(s_fn(t_hat)), float(sigma(t_hat))).float()
        d_cur = slope(x_hat, t_hat, denoised)
        if solver == "euler" or i == num_steps - 1:
            x_next = x_hat + float(h) * d_cur
        else:
            x_prime = x_hat + float(alpha * h) * d_cur
            t_prime = t_hat + f32(alpha) * h
            denoised = denoise_fn(
                x_prime / float(s_fn(t_prime)), float(sigma(t_prime))
            ).float()
            d_prime = slope(x_prime, t_prime, denoised)
            x_next = x_hat + float(h) * (
                (1 - 1 / (2 * alpha)) * d_cur + 1 / (2 * alpha) * d_prime
            )
    return x_next
