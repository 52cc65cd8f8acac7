"""Packed multi-head attention: (N, L, 3D) qkv -> (N, L, D), with its gradient.

Counterpart of maskdit_tpu/ops/flash_batched.py::packed_attention, a
``jax.custom_vjp`` whose forward and backward are both kernels. The qkv
Dense emits [q | k | v] along features, head h at [h*hd, (h+1)*hd) of each
third. ``packed_attention`` is the entry point the model calls. It applies
``AttentionFunction``, a ``torch.autograd.Function`` that saves only
``qkv`` for the backward, as the custom VJP does (flash_batched.py:171):
the backward recomputes the softmax, the output and delta from (qkv,
dout). ``AttentionFunction`` and ``launch`` (checks, launch, error) serve
ops/flash_big.py too.

  * a CPU tensor goes to the plain PyTorch versions,
    ``packed_attention_reference`` and ``packed_attention_bwd_reference``;
  * a CUDA tensor launches the hand-written kernels in
    ``csrc/packed_attention_fwd.cu`` (replaces the Pallas ``_packed_fwd``)
    and ``csrc/packed_attention_bwd.cu`` (replaces ``_packed_bwd``), or
    raises.

``packed_attention.launches`` and ``packed_attention_bwd.launches`` count
kernel launches and nothing else, so a run can show that it went through
the kernels. ``packed_attention_plain`` applies the same Function with the
plain versions on any device, for holding the kernels to them on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskdit_tpu_torch.ops import build
from maskdit_tpu_torch.ops.attention import mha_reference

KERNEL = "packed_attention_fwd"
BWD_KERNEL = "packed_attention_bwd"
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 128
# dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232448


def _align16(x: int) -> int:
    return (x + 15) & ~15


def fwd_smem_bytes(l: int, hd: int, esize: int) -> int:
    """Shared memory of one forward block: ``smem_layout`` of
    csrc/packed_attention_fwd.cu (q fp32 [hd][32], the head's K and V in
    the input type, logits fp32 [L][32], two reductions), L padded to 32."""
    lp = -(-l // 32) * 32
    k = _align16(hd * 32 * 4)
    v = _align16(k + hd * lp * esize)
    s = _align16(v + lp * hd * esize)
    red = _align16(s + lp * 32 * 4)
    return red + 2 * 8 * 32 * 4


def bwd_smem_bytes(l: int, hd: int) -> int:
    """Shared memory of the larger of the backward's two passes:
    ``query_layout`` and ``key_layout`` of csrc/packed_attention_bwd.cu
    (operands widened to fp32, rows padded to hd + 1 words)."""
    lp = -(-l // 32) * 32
    rows = lp * (hd + 1) * 4
    dout = _align16(hd * 32 * 4)
    k = _align16(dout + hd * 32 * 4)
    s = _align16(_align16(k + rows) + rows)
    query = _align16(s + lp * 32 * 4) + 2 * 8 * 32 * 4
    pb = _align16(_align16(k + rows) + rows)
    stats = _align16(_align16(pb + lp * 32 * 4) + lp * 32 * 4)
    key = stats + 3 * lp * 4
    return max(query, key)


def fits(l: int, hd: int, backward: bool) -> bool:
    """The kernels launch at (L, hd) for either input type: the forward's
    layout at fp32 (the larger) fits the card's limit, and the backward's
    too where a backward will be taken."""
    return (hd <= MAX_HEAD_DIM and fwd_smem_bytes(l, hd, 4) <= SMEM_LIMIT
            and (not backward or bwd_smem_bytes(l, hd) <= SMEM_LIMIT))


def packed_attention_reference(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, on any device."""
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    heads = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = mha_reference(heads[0], heads[1], heads[2], scale)
    return o.permute(0, 2, 1, 3).reshape(n, l, d)


def packed_attention_bwd_reference(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dqkv (N, L, 3D).

    The rounding points of the Pallas ``_bwd_kernel`` (flash_batched.py:
    98-145): fp32 logits and softmax; ``pb = p`` rounded to v's dtype for
    dv and for the recomputed o; ``delta = sum(do * o)`` in fp32; ``ds =
    p * (dp - delta) * scale`` rounded to q's dtype before the dq and dk
    products; fp32 accumulation; dqkv stored in qkv's dtype.
    """
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    heads = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0].float(), heads[1].float(), heads[2].float()
    do = dout.to(qkv.dtype).reshape(n, l, num_heads, hd).permute(0, 2, 1, 3).float()
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    pb = p.to(qkv.dtype).float()
    o = torch.matmul(pb, v)
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(pb.transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv])  # (3, N, H, L, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, l, three_d).to(qkv.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.packed_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.packed_attention_fwd.restype = ctypes.c_int
    lib.packed_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.packed_attention_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_KERNEL)
    lib.packed_attention_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.packed_attention_bwd.restype = ctypes.c_int
    lib.packed_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.packed_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def check_qkv(name: str, qkv: torch.Tensor, num_heads: int,
              aligned: bool = False) -> tuple[int, int, int, int]:
    """Device, dtype, shape and contiguity checks of a kernel's qkv;
    returns (N, L, D, hd). ``aligned``: the kernel's 16-byte tile loads
    also need head_dim a multiple of 8 and a 16-byte aligned qkv."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {qkv.device}")
    if qkv.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {qkv.dtype} (takes bfloat16 or float32)")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(
            f"{name}: qkv shape {tuple(qkv.shape)} is not (N, L, 3 * {num_heads} * hd)"
        )
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: qkv must be contiguous")
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} > {MAX_HEAD_DIM}")
    if aligned and (hd % 8 or qkv.data_ptr() % 16):
        raise ValueError(f"{name}: head dim {hd} (a multiple of 8) and a 16-byte "
                         f"aligned qkv are needed")
    return n, l, d, hd


def launch(name: str, library, entry: str, error: str, smem_bytes, qkv: torch.Tensor,
           num_heads: int, scale: float, dout: torch.Tensor | None = None,
           aligned: bool = False) -> torch.Tensor:
    """Checks the operands, then loads ``library()`` (so a tensor that no
    kernel takes raises without a build), launches its C function ``entry``
    on the current stream and raises with its ``error`` string on a refused
    launch. Without ``dout`` a forward: returns the output (N, L, D). With
    it a backward: returns dqkv (N, L, 3D). ``smem_bytes(l, hd, element
    size)`` goes into the error message."""
    n, l, d, hd = check_qkv(name, qkv, num_heads, aligned)
    if dout is None:
        out = torch.empty((n, l, d), dtype=qkv.dtype, device=qkv.device)
        pointers = (qkv.data_ptr(), out.data_ptr())
    else:
        if dout.device != qkv.device or dout.dtype != qkv.dtype:
            raise TypeError(f"{name}: dout is {dout.dtype} on {dout.device}, "
                            f"qkv {qkv.dtype} on {qkv.device}")
        if (tuple(dout.shape) != (n, l, d) or not dout.is_contiguous()
                or (aligned and dout.data_ptr() % 16)):
            raise ValueError(f"{name}: dout {tuple(dout.shape)} is not a contiguous"
                             f"{', 16-byte aligned' if aligned else ''} ({n}, {l}, {d})")
        out = torch.empty_like(qkv)
        # per-row softmax max and sum and delta = sum(do * o), (3, N, H, L)
        # fp32: written by the query pass, read by the key pass
        stats = torch.empty((3, n, num_heads, l), dtype=torch.float32, device=qkv.device)
        pointers = (qkv.data_ptr(), dout.data_ptr(), out.data_ptr(), stats.data_ptr())
    lib = library()
    with torch.cuda.device(qkv.device):
        err = getattr(lib, entry)(*pointers, n, l, num_heads, hd, scale,
                                  DTYPE_CODES[qkv.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {getattr(lib, error)(err).decode()} "
            f"(N={n}, L={l}, H={num_heads}, hd={hd}, {qkv.dtype}, "
            f"{smem_bytes(l, hd, qkv.element_size())} B shared memory per block)"
        )
    return out


def _launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    out = launch("packed_attention", _library, "packed_attention_fwd",
                 "packed_attention_error_string", fwd_smem_bytes, qkv, num_heads, scale)
    packed_attention.launches += 1
    return out


def _launch_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    dqkv = launch("packed_attention_bwd", _bwd_library, "packed_attention_bwd",
                  "packed_attention_bwd_error_string", lambda l, hd, _: bwd_smem_bytes(l, hd),
                  qkv, num_heads, scale, dout)
    packed_attention_bwd.launches += 1
    return dqkv


def packed_attention_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """dqkv (N, L, 3D) from qkv and the output's gradient (N, L, D)."""
    if qkv.device.type == "cpu":
        return packed_attention_bwd_reference(qkv, dout, num_heads, scale)
    return _launch_bwd(qkv, dout, num_heads, scale)


class AttentionFunction(torch.autograd.Function):
    """Attention from packed qkv by a forward and a backward, each a kernel's
    launch or its plain version. Saves only qkv; the backward recomputes
    everything from it. Used here and by ops/flash_big.py."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, num_heads: int, scale: float, fwd, bwd):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale, ctx.bwd = num_heads, scale, bwd
        return fwd(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        # the proj Linear hands back a gradient of its own dtype and
        # layout; the kernel takes qkv's (as g.astype(qkv.dtype) does)
        g = grad_out.to(qkv.dtype).contiguous()
        return ctx.bwd(qkv, g, ctx.num_heads, ctx.scale), None, None, None, None


def packed_attention(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """(N, L, 3D) packed qkv -> (N, L, D) attention output, differentiable."""
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, num_heads, scale)
    return AttentionFunction.apply(qkv, num_heads, scale, _launch, _launch_bwd)


def packed_attention_plain(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """``packed_attention`` with the plain forward and backward on any
    device: what the kernels are held to."""
    return AttentionFunction.apply(qkv, num_heads, scale, packed_attention_reference,
                                   packed_attention_bwd_reference)


packed_attention.launches = 0
packed_attention_bwd.launches = 0
