"""Blocked packed attention: (N, L, 3D) qkv -> (N, L, D), at any L.

Counterpart of maskdit_tpu/ops/flash_big.py::packed_attention_big, a
``jax.custom_vjp`` whose forward (``_big_fwd``) and backward (``_big_bwd``)
are Pallas kernels. There, the 512-px shapes (encoder L 1024 or 512 at
hd 72, decoder L 1024 at hd 32) run in query chunks against all keys, so a
softmax row completes in one pass. Here one head's K and V at L 1024 do
not fit a block's shared memory next to the logits, so the kernels stream
them in tiles of 64 keys (see the two sources). They take any L, so the
model also routes here a few shorter shapes (models/layers.attention_route:
the cos4 finetune's bucket of 240 kept tokens).

  * a CPU tensor goes to the plain PyTorch versions,
    ``packed_attention_big_reference`` and
    ``packed_attention_big_bwd_reference``;
  * a CUDA tensor launches ``csrc/packed_attention_big_fwd.cu`` (replaces
    ``_big_fwd``) and ``csrc/packed_attention_big_bwd.cu`` (replaces
    ``_big_bwd``), or raises. Both types run on the tensor cores: bf16 by
    the kernels of ``csrc/attention_fwd_mma.cuh`` (shared with ops/flash.py)
    and ``csrc/attention_bwd_mma.cuh`` (shared with ops/flash_batched.py);
    fp32, the released finetunes' path (``train.fp32``, TF32 off), by those
    of ``csrc/attention_fp32_mma.cuh``, each fp32 product as six bf16
    products of exact bf16 pieces of its operands.

``packed_attention_big`` applies flash_batched's ``AttentionFunction``,
which saves only qkv, as the custom VJP does (flash_big.py:198-249); the
checks and launch are flash_batched's ``launch``. The TPU kernel's
(N, 3D, L) transposes and head-group plan are tiling devices of the TPU and
are not carried over: the kernels read the packed layout in place.
``packed_attention_big.launches`` and ``packed_attention_big_bwd.launches``
count kernel launches and nothing else; ``packed_attention_big_plain``
applies the Function with the plain versions on any device. The forward is
also the torch op ``maskdit_torch::packed_attention_big_fwd``
(``packed_attention_big_fwd_op``, as flash_batched registers its own),
which ``packed_attention_big`` calls while ``torch.export`` traces.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskdit_tpu_torch.ops import build
from maskdit_tpu_torch.ops.flash_batched import (
    MAX_HEAD_DIM,
    SMEM_LIMIT,
    TILE,
    AttentionFunction,
    _packed_fwd_fake,
    fp32_bwd_smem_bytes,
    fp32_fwd_smem_bytes,
    launch,
    mma_bwd_smem_bytes,
    register_forward_op,
)

KERNEL = "packed_attention_big_fwd"
BWD_KERNEL = "packed_attention_big_bwd"
# query rows per chunk of the plain versions: the TPU kernel's block_q at
# the 512-px shapes; it bounds their fp32 temporaries to (N, H, 256, L)
BLOCK_Q = 256
# the JAX ``_plan``'s VMEM budget (maskdit_tpu/ops/flash_big.py:51)
VMEM_BUDGET = 10 * 1024 * 1024


def mma_fwd_smem_bytes(hd: int) -> int:
    """Shared memory of one block of the bf16 tensor-core forward
    (csrc/attention_fwd_mma.cuh ``smem_bytes``, shared with ops/flash.py):
    K and V rings of two bf16 [64][hd16 + 8] tiles each, hd16 = hd padded to
    a multiple of 16; the same at every L."""
    hd16 = -(-hd // 16) * 16
    return 4 * TILE * (hd16 + 8) * 2


def fwd_smem_bytes(l: int, hd: int, esize: int = 4) -> int:
    """Shared memory of one forward block for inputs of ``esize`` bytes,
    the same at every L. bf16 (2): ``mma_fwd_smem_bytes``. fp32 (4):
    flash_batched's ``fp32_fwd_smem_bytes`` (csrc/attention_fp32_mma.cuh,
    the forward #1 also runs in fp32)."""
    if esize == 2:
        return mma_fwd_smem_bytes(hd)
    return fp32_fwd_smem_bytes(hd)


def bwd_smem_bytes(l: int, hd: int, esize: int = 4) -> int:
    """Shared memory of the larger of the backward's two kernels for inputs
    of ``esize`` bytes, the same at every L. bf16 (2): flash_batched's
    ``mma_bwd_smem_bytes``; fp32 (4): its ``fp32_bwd_smem_bytes`` (the
    tensor-core kernels both backwards share)."""
    if esize == 2:
        return mma_bwd_smem_bytes(hd)
    return fp32_bwd_smem_bytes(hd)


def fits(l: int, head_dim: int) -> bool:
    """The kernels launch at (L, head_dim): head_dim a multiple of 8 (their
    16-byte tile loads) and at most 128, and both kernels' shared memory
    within a block's 232,448 B, which then holds at every L."""
    return (
        head_dim % 8 == 0 and 0 < head_dim <= MAX_HEAD_DIM
        and fwd_smem_bytes(l, head_dim) <= SMEM_LIMIT
        and bwd_smem_bytes(l, head_dim) <= SMEM_LIMIT
    )


def jax_plan(h: int, l: int, d: int):
    """The JAX package's ``_plan(h, l, d)`` (maskdit_tpu/ops/flash_big.py:
    54-86), copied: the TPU kernels' (head groups, query block) whose
    backward working set fits the TPU's VMEM budget, or None. Its window:
    head_dim a multiple of 8, L at least 512 and a multiple of 256."""
    hd = d // h
    if h * hd != d or hd % 8 != 0:
        return None
    if l < 512 or l % 256 != 0:
        return None
    for g in (1, 2, 4, 8, 16):
        if g > h or h % g != 0:
            continue
        dg = d // g
        for bq in (512, 256):
            if bq > l or l % bq:
                continue
            est = (
                2 * 7 * dg * l * 2          # double-buffered bf16 I/O blocks
                + 3 * 4 * bq * l            # fp32 s/p, dp, ds-budget
                + 2 * bq * l                # bf16 ds
                + 2 * 4 * hd * l            # fp32 dk/dv accumulators
            )
            if est <= VMEM_BUDGET:
                return g, bq
    return None


def supports(h: int, l: int, head_dim: int) -> bool:
    """True where the JAX ``flash_big.supports`` holds (``jax_plan`` finds
    a plan) and ``fits``, which holds at every L of that window."""
    return h > 0 and jax_plan(h, l, h * head_dim) is not None and fits(l, head_dim)


def _heads(qkv: torch.Tensor, num_heads: int):
    """q, k, v as fp32 (N, H, L, hd) views widened from qkv."""
    n, l, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    heads = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    return heads[0].float(), heads[1].float(), heads[2].float()


def _probs(q_chunk, k, scale):
    """fp32 logits and softmax of one query chunk against all keys."""
    s = torch.matmul(q_chunk, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def packed_attention_big_reference(
    qkv: torch.Tensor, num_heads: int, scale: float, block_q: int = BLOCK_Q
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, on any device.

    ``_fwd_kernel``'s steps (flash_big.py:98-121): query chunks of
    ``block_q`` rows against all keys, fp32 logits and softmax, ``p /
    denom`` rounded to the input type before the fp32-accumulated product
    with v, the output stored in the input type.
    """
    n, l, three_d = qkv.shape
    d = three_d // 3
    q, k, v = _heads(qkv, num_heads)
    out = torch.empty(n, num_heads, l, d // num_heads, dtype=qkv.dtype, device=qkv.device)
    for c0 in range(0, l, block_q):
        pb = _probs(q[:, :, c0:c0 + block_q], k, scale).to(qkv.dtype).float()
        out[:, :, c0:c0 + block_q] = torch.matmul(pb, v).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(n, l, d)


def packed_attention_big_bwd_reference(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float,
    block_q: int = BLOCK_Q,
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: dqkv (N, L, 3D).

    ``_bwd_kernel``'s steps and rounding points (flash_big.py:124-179), per
    query chunk: fp32 logits and softmax; ``pb = p`` rounded to v's dtype
    for o and dv; ``delta = sum(do * o)`` in fp32 from the recomputed,
    unrounded o; ``ds = p * (dp - delta) * scale`` rounded to q's dtype;
    dq stored per chunk; dk and dv accumulated in fp32 across chunks and
    rounded once at the end.
    """
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    dt = qkv.dtype
    q, k, v = _heads(qkv, num_heads)
    do = dout.to(dt).reshape(n, l, num_heads, hd).permute(0, 2, 1, 3).float()
    dq = torch.empty(n, num_heads, l, hd, dtype=dt, device=qkv.device)
    dk = torch.zeros(n, num_heads, l, hd, dtype=torch.float32, device=qkv.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, l, block_q):
        rows = slice(c0, c0 + block_q)
        p = _probs(q[:, :, rows], k, scale)
        pb = p.to(dt).float()
        o = torch.matmul(pb, v)
        delta = (do[:, :, rows] * o).sum(dim=-1, keepdim=True)
        dv += torch.matmul(pb.transpose(-1, -2), do[:, :, rows])
        dp = torch.matmul(do[:, :, rows], v.transpose(-1, -2))
        ds = (p * (dp - delta) * scale).to(dt).float()
        dq[:, :, rows] = torch.matmul(ds, k).to(dt)
        dk += torch.matmul(ds.transpose(-1, -2), q[:, :, rows])
    dqkv = torch.stack([dq, dk.to(dt), dv.to(dt)])  # (3, N, H, L, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, l, three_d)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.packed_attention_big_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.packed_attention_big_fwd.restype = ctypes.c_int
    lib.packed_attention_big_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_attention_big_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.packed_attention_big_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_big_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = build.load(BWD_KERNEL)
    lib.packed_attention_big_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.packed_attention_big_bwd.restype = ctypes.c_int
    lib.packed_attention_big_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.packed_attention_big_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.packed_attention_big_bwd_error_string.argtypes = [ctypes.c_int]
    lib.packed_attention_big_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """The forward kernel's launch: the CUDA implementation of
    ``packed_attention_big_fwd_op``, and the live Function's forward."""
    out = launch("packed_attention_big", _library, "packed_attention_big_fwd",
                 "packed_attention_big_error_string", fwd_smem_bytes, qkv, num_heads, scale,
                 aligned=True)
    packed_attention_big.launches += 1
    return out


def _launch_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    dqkv = launch("packed_attention_big_bwd", _bwd_library, "packed_attention_big_bwd",
                  "packed_attention_big_bwd_error_string", bwd_smem_bytes, qkv, num_heads, scale,
                  dout, aligned=True)
    packed_attention_big_bwd.launches += 1
    return dqkv


def packed_attention_big_bwd(
    qkv: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """dqkv (N, L, 3D) from qkv and the output's gradient (N, L, D)."""
    if qkv.device.type == "cpu":
        return packed_attention_big_bwd_reference(qkv, dout, num_heads, scale)
    return _launch_bwd(qkv, dout, num_heads, scale)


def packed_attention_big(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """(N, L, 3D) packed qkv -> (N, L, D) attention output, differentiable;
    under ``torch.export`` the forward op, without a gradient."""
    if torch.compiler.is_exporting():
        return packed_attention_big_fwd_op(qkv, num_heads, scale)
    if qkv.device.type == "cpu":
        return packed_attention_big_plain(qkv, num_heads, scale)
    return AttentionFunction.apply(qkv, num_heads, scale, _launch, _launch_bwd)


def packed_attention_big_plain(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """``packed_attention_big`` with the plain forward and backward on any
    device: what the kernels are held to."""
    return AttentionFunction.apply(qkv, num_heads, scale, packed_attention_big_reference,
                                   packed_attention_big_bwd_reference)


packed_attention_big_fwd_op = register_forward_op(
    "packed_attention_big_fwd", _launch, packed_attention_big_reference, _packed_fwd_fake)
packed_attention_big.launches = 0
packed_attention_big_bwd.launches = 0
