"""Per-(sample, head) attention with a saved logsumexp: q, k, v (N, H, L, hd).

Counterpart of maskdit_tpu/ops/flash.py, a ``jax.custom_vjp`` whose forward
(``_flash_fwd``, body ``_fwd_kernel``) and backward (``_flash_bwd``, body
``_bwd_kernel``) are Pallas kernels over (N*H, L, hd). The model reaches it
through ``model.use_flash: true`` or, at L >= 1024 where no packed kernel
fits, through ``ops/attention.mha``'s auto rule (models/layers.py routes).

It computes the packed kernels' attention with another interface and other
rounding points, so it has kernels of its own:
  * separate q, k, v; the forward returns o and an fp32 logsumexp ``lse``
    (N*H, 1, L), and the Function saves (q, k, v, o, lse), as the custom
    VJP does (flash.py:87-129);
  * the backward stays in fp32 until it stores dq, dk and dv: p =
    exp(s - lse) and ds are not rounded, and delta = sum(do * o) reads the
    stored o, already rounded to the input type.

  * a CPU tensor goes to the plain PyTorch versions,
    ``flash_fwd_reference`` and ``flash_bwd_reference``;
  * a CUDA tensor launches ``csrc/flash_fwd.cu`` (replaces ``_flash_fwd``)
    and ``csrc/flash_bwd.cu`` (replaces ``_flash_bwd``), or raises. Both
    types run tensor-core kernels (``fwd_kernel``, ``bwd_kernel``): bf16
    the forward of ``csrc/attention_fwd_mma.cuh`` (shared with
    ops/flash_big.py) and a backward that splits p and ds exactly into
    three bf16 pieces; fp32 (``model.use_flash`` with ``train.fp32``) the
    kernels of ``csrc/attention_fp32_mma.cuh`` in their separate-heads
    layout (shared with the packed kernels in fp32), each fp32 product as
    six bf16 products of exact pieces, lse written by the forward and p =
    exp(s - lse) in the backward. They take a head dim that is a multiple
    of 8 up to 128; any other raises NotImplementedError. Their shared
    memory does not grow with L.

``flash_fwd.launches`` and ``flash_bwd.launches`` count kernel launches
and nothing else; ``flash_mha_plain`` applies the Function with the plain
versions on any device, what the kernels are held to. The forward is also
the torch op ``maskdit_torch::flash_fwd`` (``flash_fwd_op``, as
flash_batched registers its own), which ``flash_mha`` calls while
``torch.export`` traces.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskdit_tpu_torch.ops import build
from maskdit_tpu_torch.ops.attention import mha_reference
from maskdit_tpu_torch.ops.flash_batched import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    fp32_bwd_smem_bytes,
    fp32_fwd_smem_bytes,
    register_forward_op,
)
from maskdit_tpu_torch.ops.flash_big import mma_fwd_smem_bytes

KERNEL = "flash_fwd"
BWD_KERNEL = "flash_bwd"
LANE = 128
MAX_L = 2048
# rows of the tiles the bf16 backward keeps in shared memory
TILE = 64


def supports(l: int) -> bool:
    """The JAX kernel's window (flash.py:132-134): L lane-aligned, at most
    2048."""
    return l % LANE == 0 and l <= MAX_L


def fwd_smem_bytes(hd: int, esize: int = 4) -> int:
    """Shared memory of one forward block for inputs of ``esize`` bytes, the
    same at every L. bf16 (2): the tensor-core kernel's,
    ``flash_big.mma_fwd_smem_bytes``. fp32 (4): flash_batched's
    ``fp32_fwd_smem_bytes`` (csrc/attention_fp32_mma.cuh; the separate-heads
    layout keeps the packed one's Q tile and K and V rings)."""
    return mma_fwd_smem_bytes(hd) if esize == 2 else fp32_fwd_smem_bytes(hd)


def bwd_smem_bytes(hd: int, esize: int = 4) -> int:
    """Shared memory of the larger of the backward's two kernels for inputs
    of ``esize`` bytes, the same at every L (csrc/flash_bwd.cu). bf16 (2):
    the tensor-core key kernel's six bf16 [64][hd16 + 8] tiles (its K and V,
    the Q and dO rings; hd16 = hd padded to a multiple of 16) and its fp32
    p^T and ds^T tiles, [64][72] each. fp32 (4): flash_batched's
    ``fp32_bwd_smem_bytes`` (csrc/attention_fp32_mma.cuh: the same tiles in
    both layouts; the query kernel's lse and delta come from device memory,
    not shared memory)."""
    if esize == 2:
        hd16 = -(-hd // 16) * 16
        return 6 * TILE * (hd16 + 8) * 2 + 2 * TILE * (TILE + 8) * 4
    return fp32_bwd_smem_bytes(hd)


def bwd_kernel(dtype: torch.dtype) -> str:
    """Which kernels a call runs, forward or backward: 'mma', bf16 operands
    on mma.sync (the backward splits p and ds exactly into three bf16
    pieces); 'mma6', fp32, the kernels of csrc/attention_fp32_mma.cuh, each
    product as six bf16 mma.sync products of exact pieces, as
    ``flash_batched.bwd_kernel`` names them."""
    return "mma" if dtype == torch.bfloat16 else "mma6"


fwd_kernel = bwd_kernel


def check_head_dim(name: str, shape: tuple) -> None:
    """The kernels load 16 bytes at a time: hd a multiple of 8, at most
    128. Another hd in the window raises, rather than run plain code where
    the JAX package runs a kernel."""
    hd = shape[-1]
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{name} at {tuple(shape)}: the kernel takes a head dim that is a "
            f"multiple of 8 up to {MAX_HEAD_DIM}, not {hd}"
        )


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, on any device:
    ``_fwd_kernel`` (flash.py:30-45) step by step. q, k, v (N*H, L, hd) ->
    o (N*H, L, hd) in q's type and lse (N*H, 1, L) fp32."""
    n, l, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.matmul((p / lsum).to(v.dtype).float(), v.float())
    lse = (m + torch.log(lsum)).reshape(n, 1, l)
    return o.to(q.dtype), lse


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, scale: float):
    """Plain PyTorch version of the backward kernel, on any device:
    ``_bwd_kernel`` (flash.py:48-78) step by step, fp32 until dq, dk and dv
    are stored in their inputs' types."""
    n, l, _ = q.shape
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(n, l, 1))
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_KERNEL)
    lib.flash_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_bwd.restype = ctypes.c_int
    lib.flash_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.flash_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int, int]:
    """Device, type, shape, layout and alignment checks of the (N*H, L, hd)
    operands; returns (N*H, L, hd)."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {first.device}")
    if first.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype} (takes bfloat16 or float32)")
    if first.dim() != 3:
        raise ValueError(f"{name}: shape {tuple(first.shape)} is not (N*H, L, hd)")
    check_head_dim(name, tuple(first.shape))
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype or t.shape != first.shape:
            raise ValueError(f"{name}: operands {[(tuple(x.shape), x.dtype, str(x.device)) for x in tensors]} "
                             "differ in shape, type or device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")
    return tuple(first.shape)


def _raise_on(name: str, lib, error: str, err: int, shape, dtype, smem: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {getattr(lib, error)(err).decode()} "
                           f"((N*H, L, hd)={tuple(shape)}, {dtype}, {smem} B shared memory "
                           "per block)")


def _launch_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch: the CUDA implementation of
    ``flash_fwd_op``, and the live Function's forward."""
    n, l, hd = _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((n, 1, l), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), n, l, hd, scale, DTYPE_CODES[q.dtype],
                            torch.cuda.current_stream().cuda_stream)
    _raise_on("flash_fwd", lib, "flash_fwd_error_string", err, q.shape, q.dtype,
              fwd_smem_bytes(hd, q.element_size()))
    flash_fwd.launches += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, scale: float):
    n, l, hd = _check("flash_bwd", q, k, v, o, do)
    if lse.dtype != torch.float32 or lse.numel() != n * l or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse {tuple(lse.shape)} {lse.dtype} is not a contiguous "
                         f"fp32 ({n}, 1, {l}) on {q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # delta = sum(do * o) per query row, fp32: written by a first pass, read
    # by the key and query passes
    delta = torch.empty((n, l), dtype=torch.float32, device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), delta.data_ptr(), n, l, hd, scale,
                            DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _raise_on("flash_bwd", lib, "flash_bwd_error_string", err, q.shape, q.dtype,
              bwd_smem_bytes(hd, q.element_size()))
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """(o, lse) from q, k, v (N*H, L, hd)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)


def flash_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) from the forward's residuals and o's gradient."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, scale)
    return _launch_bwd(q, k, v, o, lse, do, scale)


class FlashFunction(torch.autograd.Function):
    """o from q, k, v (N*H, L, hd) by a forward and a backward, each a
    kernel's launch or its plain version; saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, fwd, bwd):
        o, lse = fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.bwd = scale, bwd
        return o

    @staticmethod
    def backward(ctx, grad_o: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        g = grad_o.to(o.dtype).contiguous()
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, g, ctx.scale)
        return dq, dk, dv, None, None, None


def _apply(q, k, v, attend) -> torch.Tensor:
    """``attend(q, k, v, scale) -> o`` on the (N*H, L, hd) layout of the
    (N, H, L, hd) q, k, v; the plain ``mha_reference`` past the window."""
    n, h, l, hd = q.shape
    if not supports(l):
        return mha_reference(q, k, v)

    def prep(x):
        return x.reshape(n * h, l, hd).contiguous()

    out = attend(prep(q), prep(k), prep(v), hd ** -0.5)
    return out.reshape(n, h, l, hd)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, H, L, hd) attention through the kernels, differentiable; where
    ``supports(L)`` fails, the plain ``mha_reference``, as the JAX
    ``flash_mha`` falls back (flash.py:144-148). Under ``torch.export`` the
    forward op, without a gradient."""
    if torch.compiler.is_exporting():
        return _apply(q, k, v, lambda *args: flash_fwd_op(*args)[0])
    return _apply(q, k, v, lambda *args: FlashFunction.apply(*args, flash_fwd, flash_bwd))


def flash_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``flash_mha`` with the plain forward and backward on any device."""
    return _apply(q, k, v, lambda *args: FlashFunction.apply(*args, flash_fwd_reference,
                                                              flash_bwd_reference))


def _flash_fwd_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    n, l, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((n, 1, l), dtype=torch.float32)


flash_fwd_op = register_forward_op("flash_fwd", _launch_fwd, flash_fwd_reference,
                                   _flash_fwd_fake)
flash_fwd.launches = 0
flash_bwd.launches = 0
