"""Single-sweep fused Adam + EMA update.

Counterpart of maskdit_tpu/ops/fused_adam.py (``fused_adam_ema``, the
Pallas ``_leaf_update_pallas``, the jnp ``_leaf_update_jnp`` with
``stochastic_round_bf16``, and ``FusedAdamEma``). Per element:

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
kernel is held to on the card.

Storage: p and ema are fp32. The gradient may be bf16 (``amp_grads``; it
is upcast at the boundary). The first moment may be stored in bf16
(``mu_dtype``, rounded to nearest; the math stays fp32). The second moment
may be stored in bf16 (``nu_dtype``) with STOCHASTIC rounding, as
``stochastic_round_bf16`` does: its per-step increment (1 - b2) is below
bf16's resolution, so round-to-nearest would freeze it. The random bits are
Philox4x32-10 keyed by (0x6E75, count), count the pre-increment Adam step,
with the element's index in the flat buffer as the counter
(``sr_bits``): deterministic across resume, as the JAX key folded from the
count is, but not threefry's bits, so the two packages agree in
distribution, not value. The plain version computes the same Philox in
int64 tensor arithmetic, so kernel and plain agree bit for bit.
``with_ema=False`` (the steps of ``ema_every > 1`` without the EMA)
leaves ema untouched; JAX passes d = 1.0 there, which gives the same
value whenever p is finite.

``StagedAdamEma`` is the update without the kernel (``train.fused_adam:
false``): ``staged_adam_ema`` runs optax's stages as plain PyTorch
expressions over the flat buffers, with the roundings of ``optax.adam``
(``optax.adamw`` with weight decay) or, with a bf16 nu, of this package's
``adam_sr_nu``, whose stochastic rounding it shares with the kernel.
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
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
SR_KEY = 0x6E75  # the JAX package's PRNGKey(0x6E75) for nu's rounding
_M32 = 0xFFFFFFFF
# elements per piece of the plain stochastic rounding: bounds its int64
# temporaries (128 MB each), while few pieces keep the ~300 small launches
# each piece takes on a card from bounding the staged update's time
_SR_PIECE = 1 << 24

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


def _mulhilo(a: torch.Tensor, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of a * b (a: int64 holding uint32, b < 2^32)
    without overflowing int64: a is split into 16-bit halves."""
    x = (a & 0xFFFF) * b
    y = (a >> 16) * b
    t = x + ((y & 0xFFFF) << 16)
    return ((y >> 16) + (t >> 32)) & _M32, t & _M32


def philox4x32_10(c: tuple[torch.Tensor, ...], key: tuple[int, int]) -> tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Random123) of the counters ``c`` (four int64 tensors
    of uint32 values) under ``key`` (two uint32): the four output words.
    The kernel's ``philox4x32_10`` in integer tensor arithmetic."""
    c0, c1, c2, c3 = c
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def sr_bits(start: int, n: int, count: int, device) -> torch.Tensor:
    """The random words of elements ``start .. start+n-1`` (int64 holding
    uint32): element i takes word i % 4 of Philox at counter (i // 4, 0, 0)
    under the key (0x6E75, count)."""
    q0, q1 = start // 4, (start + n - 1) // 4 + 1
    q = torch.arange(q0, q1, dtype=torch.int64, device=device)
    zero = torch.zeros_like(q)
    words = torch.stack(philox4x32_10((q & _M32, q >> 32, zero, zero), (SR_KEY, count & _M32)),
                        dim=1).reshape(-1)
    return words[start - 4 * q0:start - 4 * q0 + n]


def stochastic_round_bf16(x: torch.Tensor, count: int, start: int = 0) -> torch.Tensor:
    """fp32 -> bf16 with stochastic rounding (``stochastic_round_bf16`` of
    the JAX package with the port's bits): the low 16 bits of each
    element's random word are added to its fp32 pattern, which is then
    truncated to its upper half. ``x`` is flat; its element k is the flat
    buffer's element ``start + k``."""
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    for lo in range(0, x.numel(), _SR_PIECE):
        piece = x[lo:lo + _SR_PIECE].float()
        u = piece.view(torch.int32).to(torch.int64) & _M32
        bits = sr_bits(start + lo, piece.numel(), count, x.device)
        hi = ((u + (bits & 0xFFFF)) >> 16) & 0xFFFF
        out[lo:lo + _SR_PIECE] = (hi - ((hi & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)
    return out


def fused_adam_ema_reference(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, bc1: float, bc2: float, decay: float,
    one_minus_decay: float, b1: float, one_minus_b1: float, b2: float,
    one_minus_b2: float, eps: float, sr_count: Optional[int] = None,
    with_ema: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: new (p, m, v, ema), out of place.

    The operation order of ``_leaf_update_jnp`` (fused_adam.py:128-152);
    m and v are returned in their own dtypes, p and ema in fp32. A bf16 v
    is stochastically rounded with the bits of ``sr_count`` (the tensors
    are the flat buffers, or their first elements); ``with_ema=False``
    returns ema itself.
    """
    g = g.float()
    # the divisors as tensors on the data's device: PyTorch's CUDA division
    # by a Python scalar multiplies by its reciprocal, which is not the
    # kernel's (and JAX's) rounding
    bc1, bc2 = (torch.tensor(b, dtype=torch.float32, device=p.device) for b in (bc1, bc2))
    m_new = b1 * m.float() + one_minus_b1 * g
    v_new = b2 * v.float() + one_minus_b2 * g * g
    p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    e_new = decay * e + one_minus_decay * p_new if with_ema else e
    if v.dtype == torch.float32:
        v_store = v_new
    elif sr_count is None:
        raise ValueError("a bf16 second moment needs stochastic rounding (sr_count); "
                         "round-to-nearest freezes it at (1 - b2) increments")
    else:
        v_store = stochastic_round_bf16(v_new.reshape(-1), sr_count).view(v.shape)
    return p_new, m_new.to(m.dtype), v_store, e_new


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.fused_adam_ema.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_uint]
        + [ctypes.c_float] * 10 + [ctypes.c_void_p]
    )
    lib.fused_adam_ema.restype = ctypes.c_int
    lib.fused_adam_ema_error_string.argtypes = [ctypes.c_int]
    lib.fused_adam_ema_error_string.restype = ctypes.c_char_p
    return lib


_SCALAR_ORDER = ("lr", "bc1", "bc2", "decay", "one_minus_decay", "b1",
                 "one_minus_b1", "b2", "one_minus_b2", "eps")
_NARROW = ("g", "m", "v")  # may be bf16


def launch(g, p, m, v, e, scalars: dict[str, float], sr_count: int = 0,
           with_ema: bool = True) -> None:
    """Launch the kernel with the given fp32 scalars (``adam_scalars``'s
    keys) on CUDA tensors; counts one launch."""
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v), ("ema", e)):
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"fused_adam_ema: {name} on {t.device}, p on {p.device}")
        if t.shape != p.shape or not t.is_contiguous():
            raise ValueError(
                f"fused_adam_ema: {name} is {tuple(t.shape)} "
                f"(contiguous {t.is_contiguous()}), p {tuple(p.shape)}"
            )
        want = tuple(_DTYPE_CODES) if name in _NARROW else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"fused_adam_ema: {name} is {t.dtype} (takes {want})")
    lib = _library()
    with torch.cuda.device(p.device):
        err = lib.fused_adam_ema(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), e.data_ptr(),
            p.numel(), _DTYPE_CODES[g.dtype], _DTYPE_CODES[m.dtype], _DTYPE_CODES[v.dtype],
            int(with_ema), sr_count & _M32, *(scalars[k] for k in _SCALAR_ORDER),
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
    with_ema: bool = True,
) -> None:
    """Update p, m, v and ema in place from the gradient g.

    ``count_inc`` is the post-increment step (optax's convention for the
    bias correction); ``lr`` is the schedule's value at the step before.
    A bf16 v is stochastically rounded with the bits of ``count_inc - 1``.
    """
    if p.device.type == "cpu":
        fused_adam_ema_plain(g, p, m, v, e, lr=lr, count_inc=count_inc, b1=b1, b2=b2,
                             eps=eps, ema_decay=ema_decay, with_ema=with_ema)
        return
    launch(g, p, m, v, e, adam_scalars(lr, count_inc, b1, b2, eps, ema_decay),
           sr_count=count_inc - 1, with_ema=with_ema)


def fused_adam_ema_plain(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, count_inc: int, b1: float = 0.9,
    b2: float = 0.999, eps: float = 1e-8, ema_decay: float = 0.9999,
    with_ema: bool = True,
) -> None:
    """``fused_adam_ema`` through the plain version on any device, in place:
    what the kernel is held to."""
    new = fused_adam_ema_reference(
        g, p, m, v, e, **adam_scalars(lr, count_inc, b1, b2, eps, ema_decay),
        sr_count=count_inc - 1, with_ema=with_ema,
    )
    for dst, src in zip((p, m, v, e), new):
        if src is not dst:
            dst.copy_(src)


fused_adam_ema.launches = 0


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def staged_adam_ema(
    g: torch.Tensor, p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    e: torch.Tensor, *, lr: float, count: int, b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, weight_decay: float = 0.0, ema_decay: float = 0.9999,
    with_ema: bool = True,
) -> None:
    """The staged update (JAX state.py:205-224) in place: Adam's
    ``optimizer.update``, ``optax.apply_updates`` and, unless ``with_ema`` is
    False, ``optax.incremental_update`` of the EMA at step size ``1 -
    ema_decay``, each a pass of plain PyTorch over the flat buffers. ``count``
    is Adam's pre-increment count, ``lr`` the schedule's value there.

    The stages and their roundings, as the JAX package forms them:
      * fp32 nu, ``optax.adam`` (``scale_by_adam`` then ``scale(-lr)``): m
        = (1 - b1) * g + b1 * m and v = (1 - b2) * g**2 + b2 * v, each
        constant in the dtype of the array it multiplies (a Python float
        next to a bf16 array is bf16: b1 beside a bf16 mu, 1 - b1 and g**2
        with a bf16 gradient), the products and sums in fp32; where g and
        mu are both bf16, mu's two products, their sum and its bias
        correction rounded to bf16, as XLA computes the jitted step; with
        ``weight_decay`` (``optax.adamw``) the update gains wd * p;
      * bf16 nu, ``adam_sr_nu`` (maskdit_tpu/ops/fused_adam.py:233-293): g
        upcast first, m = b1 * m + (1 - b1) * g, v = b2 * v + (1 - b2) * g
        * g, nu stored by ``stochastic_round_bf16`` with the bits of
        ``count``, the kernel's;
      * both: u = (m / bc1) / (sqrt(v / bc2) + eps), bc = 1 - b**(count +
        1) in fp32, p = p + (-lr) * u, mu stored in its dtype (rounded to
        nearest), ema = s * p + (1 - s) * ema with s = 1 - ema_decay.
    Every scalar is a 0-d fp32 tensor on the data's device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal).
    """
    f32 = np.float32
    const = lambda x, dtype=torch.float32: torch.tensor(x, dtype=dtype, device=p.device).float()
    t = f32(count + 1)
    bc1, bc2 = (const(f32(1.0) - f32(b) ** t) for b in (b1, b2))
    if v.dtype == torch.bfloat16:
        gf = g.float()
        m_new = const(b1) * m.float() + const(1.0 - b1) * gf
        v_new = const(b2) * v.float() + const(1.0 - b2) * gf * gf
        del gf
    else:
        m_new = const(1.0 - b1, g.dtype) * g.float()
        old = const(b1, m.dtype) * m.float()
        if g.dtype == m.dtype == torch.bfloat16:  # optax's new mu is bf16 then
            m_new = (m_new.bfloat16() + old.bfloat16()).float()
            bc1 = bc1.bfloat16().float()
        else:
            m_new += old
        del old
        v_new = const(1.0 - b2, g.dtype) * (g * g).float() + const(b2) * v
    u = (m_new / bc1).div_(torch.sqrt(v_new / bc2).add_(const(eps)))
    if weight_decay != 0.0:
        u.add_(const(weight_decay) * p)
    p.add_(u.mul_(const(-lr)))
    del u
    m.copy_(m_new)
    del m_new
    if v.dtype == torch.bfloat16:
        v.copy_(stochastic_round_bf16(v_new.reshape(-1), count).view(v.shape))
    else:
        v.copy_(v_new)
    del v_new
    if with_ema:
        step_size = 1.0 - ema_decay
        e.mul_(const(1.0 - step_size)).add_(const(step_size) * p)


class FusedAdamEma:
    """Adam + EMA with optax's state (count, mu, nu) and one fused update.

    ``update_with_ema`` replaces optax's update, apply_updates and
    incremental_update with one sweep, in place. ``learning_rate`` is a
    float or a function of the pre-increment count. ``mu_dtype`` and
    ``nu_dtype`` store the moments in bf16 (see the module docstring).
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
        if mu_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype {mu_dtype}: float32 or bfloat16")
        if nu_dtype not in (None, torch.bfloat16):
            # FusedAdamEma's guard (fused_adam.py:335-339)
            raise ValueError(f"nu_dtype={str(nu_dtype).replace('torch.', '')}: only bfloat16 "
                             "narrow nu storage is implemented (stochastic rounding targets "
                             "bf16)")
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu_dtype = mu_dtype or torch.float32
        self.nu_dtype = nu_dtype or torch.float32

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: torch.Tensor) -> AdamState:
        zeros = lambda dt: torch.zeros(params.shape, dtype=dt, device=params.device)
        return AdamState(count=0, mu=zeros(self.mu_dtype), nu=zeros(self.nu_dtype))

    def update_with_ema(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor,
        ema: torch.Tensor, ema_decay: float = 0.9999, with_ema: bool = True,
    ) -> None:
        """One step: params, state.mu, state.nu and ema (unless
        ``with_ema`` is False) change in place and state.count goes up by
        one."""
        fused_adam_ema(
            grads, params, state.mu, state.nu, ema,
            lr=self.lr_at(state.count), count_inc=state.count + 1,
            b1=self.b1, b2=self.b2, eps=self.eps, ema_decay=ema_decay, with_ema=with_ema,
        )
        state.count += 1


class StagedAdamEma(FusedAdamEma):
    """``FusedAdamEma``'s state and interface with the staged update
    (``staged_adam_ema``): the JAX package's optimizer where
    ``train.fused_adam`` is false, ``optax.adam`` (``optax.adamw`` with
    ``weight_decay``) or, with a bf16 ``nu_dtype``, ``adam_sr_nu``. Its
    state is the same ``AdamState``, so checkpoints and
    ``utils.port.optimizer_state_from_flax`` serve both."""

    def __init__(self, learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None, nu_dtype: Optional[torch.dtype] = None):
        super().__init__(learning_rate, b1, b2, eps, mu_dtype, nu_dtype)
        self.weight_decay = weight_decay

    def update_with_ema(
        self, grads: torch.Tensor, state: AdamState, params: torch.Tensor,
        ema: torch.Tensor, ema_decay: float = 0.9999, with_ema: bool = True,
    ) -> None:
        """As ``FusedAdamEma.update_with_ema``, through the staged update."""
        staged_adam_ema(
            grads, params, state.mu, state.nu, ema, lr=self.lr_at(state.count),
            count=state.count, b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, ema_decay=ema_decay, with_ema=with_ema,
        )
        state.count += 1
