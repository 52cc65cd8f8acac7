"""Single-sweep fused Adam + EMA update.

Counterpart of maskdit_tpu/ops/fused_adam.py (``fused_adam_ema``, the
Pallas ``_leaf_update_pallas`` and ``FusedAdamEma``). Per element:

    m   <- b1*m + (1-b1)*g
    v   <- b2*v + (1-b2)*g^2
    p   <- p - lr * (m/bc1) / (sqrt(v/bc2) + eps)
    ema <- d*ema + (1-d)*p

with bias correction at the post-increment count (bc = 1 - b^(count+1)),
the learning rate at the pre-increment count, eps outside the sqrt and the
EMA of the NEW params: optax.scale_by_adam's math, which is torch/apex
Adam's.

  * a CPU tensor takes ``fused_adam_ema_reference``, the plain PyTorch
    version (the JAX ``_leaf_update_jnp`` math);
  * a CUDA tensor launches the hand-written kernel in
    ``csrc/fused_adam_ema.cu``, or raises.

Both update p, m, v and ema IN PLACE, as the Pallas call aliases its
outputs onto its inputs (fused_adam.py:121). The trainer keeps each of the
five as one flat buffer (``train/state.py``), so a step is one launch;
``fused_adam_ema.launches`` counts them; ``fused_adam_ema_plain`` is the
same in-place update through the plain version on any device, what the
kernel is held to on the card. The first moment may be stored
in bf16 (``mu_dtype``; the math stays fp32), as the Pallas kernel allows.
bf16 second moments need stochastic rounding, which neither the Pallas
kernel nor this one does: ``nu_dtype`` raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from maskdit_tpu_torch.ops import build

KERNEL = "fused_adam_ema"
_M_CODES = {torch.bfloat16: 0, torch.float32: 1}

LearningRate = Union[float, Callable[[int], float]]


def adam_scalars(lr: float, count_inc: int, b1: float, b2: float, eps: float,
                 ema_decay: float) -> dict[str, float]:
    """The step's scalars, rounded to fp32 as the JAX package forms them:
    ``lr`` and ``1 - b^t`` (t = ``count_inc``, the post-increment count)
    and the EMA decay and its complement in fp32; ``1 - b1`` and ``1 - b2``
    in double, then fp32 (Python floats next to an fp32 array)."""
    f32 = np.float32
    t = f32(count_inc)
    return dict(
        lr=float(f32(lr)),
        bc1=float(f32(1.0) - f32(b1) ** t),
        bc2=float(f32(1.0) - f32(b2) ** t),
        decay=float(f32(ema_decay)),
        one_minus_decay=float(f32(1.0) - f32(ema_decay)),
        b1=float(f32(b1)),
        one_minus_b1=float(f32(1.0 - b1)),
        b2=float(f32(b2)),
        one_minus_b2=float(f32(1.0 - b2)),
        eps=float(f32(eps)),
    )


def fused_adam_ema_reference(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, bc1: float, bc2: float, decay: float,
    one_minus_decay: float, b1: float, one_minus_b1: float, b2: float,
    one_minus_b2: float, eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: new (p, m, v, ema), out of place.

    The operation order of ``_leaf_update_jnp`` (fused_adam.py:128-152);
    m is returned in its own dtype, the rest in fp32.
    """
    g = g.float()
    m_new = b1 * m.float() + one_minus_b1 * g
    v_new = b2 * v + one_minus_b2 * g * g
    p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    e_new = decay * e + one_minus_decay * p_new
    return p_new, m_new.to(m.dtype), v_new, e_new


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.fused_adam_ema.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
        + [ctypes.c_float] * 10 + [ctypes.c_void_p]
    )
    lib.fused_adam_ema.restype = ctypes.c_int
    lib.fused_adam_ema_error_string.argtypes = [ctypes.c_int]
    lib.fused_adam_ema_error_string.restype = ctypes.c_char_p
    return lib


_SCALAR_ORDER = ("lr", "bc1", "bc2", "decay", "one_minus_decay", "b1",
                 "one_minus_b1", "b2", "one_minus_b2", "eps")


def _launch(g, p, m, v, e, scalars: dict[str, float]) -> None:
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v), ("ema", e)):
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"fused_adam_ema: {name} on {t.device}, p on {p.device}")
        if t.shape != p.shape or not t.is_contiguous():
            raise ValueError(
                f"fused_adam_ema: {name} is {tuple(t.shape)} "
                f"(contiguous {t.is_contiguous()}), p {tuple(p.shape)}"
            )
        want = (torch.bfloat16, torch.float32) if name == "m" else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"fused_adam_ema: {name} is {t.dtype} (takes {want})")
    lib = _library()
    with torch.cuda.device(p.device):
        err = lib.fused_adam_ema(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), e.data_ptr(),
            p.numel(), _M_CODES[m.dtype], *(scalars[k] for k in _SCALAR_ORDER),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_adam_ema kernel launch failed: "
            f"{lib.fused_adam_ema_error_string(err).decode()} ({p.numel()} elements)"
        )
    fused_adam_ema.launches += 1


def fused_adam_ema(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, count_inc: int, b1: float = 0.9,
    b2: float = 0.999, eps: float = 1e-8, ema_decay: float = 0.9999,
) -> None:
    """Update p, m, v and ema in place from the gradient g.

    ``count_inc`` is the post-increment step (optax's convention for the
    bias correction); ``lr`` is the schedule's value at the step before.
    """
    if p.device.type == "cpu":
        fused_adam_ema_plain(g, p, m, v, e, lr=lr, count_inc=count_inc, b1=b1, b2=b2,
                             eps=eps, ema_decay=ema_decay)
        return
    _launch(g, p, m, v, e, adam_scalars(lr, count_inc, b1, b2, eps, ema_decay))


def fused_adam_ema_plain(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, count_inc: int, b1: float = 0.9,
    b2: float = 0.999, eps: float = 1e-8, ema_decay: float = 0.9999,
) -> None:
    """``fused_adam_ema`` through the plain version on any device, in place:
    what the kernel is held to."""
    new = fused_adam_ema_reference(g, p, m, v, e, **adam_scalars(lr, count_inc, b1, b2, eps,
                                                                 ema_decay))
    for dst, src in zip((p, m, v, e), new):
        dst.copy_(src)


fused_adam_ema.launches = 0


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class FusedAdamEma:
    """Adam + EMA with optax's state (count, mu, nu) and one fused update.

    ``update_with_ema`` replaces optax's update, apply_updates and
    incremental_update with one sweep, in place. ``learning_rate`` is a
    float or a function of the pre-increment count.
    """

    def __init__(
        self,
        learning_rate: LearningRate,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        mu_dtype: Optional[torch.dtype] = None,
        nu_dtype: Optional[torch.dtype] = None,
    ):
        if nu_dtype is not None:
            raise NotImplementedError(
                "nu_dtype: a bf16 second moment needs stochastic rounding, "
                "which the port's kernel does not do yet"
            )
        if mu_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype {mu_dtype}: float32 or bfloat16")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype or torch.float32

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(
            count=0,
            mu=torch.zeros(params.shape, dtype=self.mu_dtype, device=params.device),
            nu=torch.zeros_like(params, dtype=torch.float32),
        )

    def update_with_ema(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor,
        ema: torch.Tensor, ema_decay: float = 0.9999,
    ) -> None:
        """One step: params, state.mu, state.nu and ema change in place and
        state.count goes up by one."""
        fused_adam_ema(
            grads, params, state.mu, state.nu, ema,
            lr=self.lr_at(state.count), count_inc=state.count + 1,
            b1=self.b1, b2=self.b2, eps=self.eps, ema_decay=ema_decay,
        )
        state.count += 1
