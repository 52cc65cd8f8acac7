"""Blocked packed attention: (N, L, 3D) qkv -> (N, L, D), at any L.

Counterpart of maskdit_tpu/ops/flash_big.py::packed_attention_big, a
``jax.custom_vjp`` whose forward (``_big_fwd``) and backward (``_big_bwd``)
are Pallas kernels. There, the 512-px shapes (encoder L 1024 or 512 at
hd 72, decoder L 1024 at hd 32) run in query chunks against all keys, so a
softmax row completes in one pass. Here one head's K and V at L 1024 do
not fit a block's shared memory next to the logits, so the kernels stream
them in tiles of 64 keys (see the two sources). They take any L, so the
model also routes here the whole-row shapes whose backward does not fit
the card (models/layers.attention_route).

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
applies the Function with the plain versions on any device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskdit_tpu_torch.ops import build
from maskdit_tpu_torch.ops.flash_batched import (
    MAX_HEAD_DIM,
    SMEM_LIMIT,
    AttentionFunction,
    launch,
    mma_bwd_smem_bytes,
)

KERNEL = "packed_attention_big_fwd"
BWD_KERNEL = "packed_attention_big_bwd"
# query rows per chunk of the plain versions: the TPU kernel's block_q at
# the 512-px shapes; it bounds their fp32 temporaries to (N, H, 256, L)
BLOCK_Q = 256
# keys (or queries, in the backward's key pass) per tile the kernels stream
TILE = 64
# an SM's shared memory, and what the system keeps of it for each block
SM_SMEM, BLOCK_RESERVE = 233472, 1024


def mma_fwd_smem_bytes(hd: int) -> int:
    """Shared memory of one block of the bf16 tensor-core forward
    (csrc/attention_fwd_mma.cuh ``smem_bytes``, shared with ops/flash.py):
    K and V rings of two bf16 [64][hd16 + 8] tiles each, hd16 = hd padded to
    a multiple of 16; the same at every L."""
    hd16 = -(-hd // 16) * 16
    return 4 * TILE * (hd16 + 8) * 2


def _fp32_strides(hd: int) -> tuple[int, int]:
    """Row strides, in floats, of the fp32 kernels' tiles
    (csrc/attention_fp32_mma.cuh ``a_stride``, ``b_stride``)."""
    return (hd if hd % 16 == 8 else hd + 8), hd + 4


def fwd_smem_bytes(l: int, hd: int, esize: int = 4) -> int:
    """Shared memory of one forward block for inputs of ``esize`` bytes,
    the same at every L. bf16 (2): ``mma_fwd_smem_bytes``. fp32 (4):
    csrc/attention_fp32_mma.cuh ``fwd_smem_bytes``, the Q tile and the K and
    V rings of two fp32 tiles of 64 rows each."""
    if esize == 2:
        return mma_fwd_smem_bytes(hd)
    a, b = _fp32_strides(hd)
    return TILE * (a + 4 * b) * 4


def fp32_key_depth(hd: int) -> int:
    """Tiles in the fp32 key kernel's Q and dO rings: two where two blocks
    still share an SM, else one (csrc/attention_fp32_mma.cuh ``key_depth``)."""
    a, b = _fp32_strides(hd)
    two = TILE * (2 * a + 4 * b + 2 * (TILE + 8)) * 4
    return 2 if 2 * (two + BLOCK_RESERVE) <= SM_SMEM else 1


def bwd_smem_bytes(l: int, hd: int, esize: int = 4) -> int:
    """Shared memory of the larger of the backward's two kernels for inputs
    of ``esize`` bytes, the same at every L. bf16 (2): flash_batched's
    ``mma_bwd_smem_bytes`` (the tensor-core kernels both backwards share).
    fp32 (4): csrc/attention_fp32_mma.cuh's query kernel (Q and dO tiles, K
    and V rings) and key kernel (its K and V, Q and dO rings of
    ``fp32_key_depth`` tiles, p^T and ds^T [64][72])."""
    if esize == 2:
        return mma_bwd_smem_bytes(hd)
    a, b = _fp32_strides(hd)
    query = TILE * (2 * a + 4 * b) * 4
    key = TILE * (2 * a + 2 * fp32_key_depth(hd) * b + 2 * (TILE + 8)) * 4
    return max(query, key)


def route_window(l: int, head_dim: int) -> bool:
    """The L at which the route may send (L, head_dim) to these kernels:
    where the first fp32 kernels' shared memory fitted a block (their
    query pass kept a (32, L) fp32 logits row block, Q and dO, two fp32
    tiles of 64 rows and two reductions: 128 L + 768 hd + 2,560 B, L padded
    to 64, within 232,448 B). The tensor-core kernels' layouts no longer
    grow with L; the window is kept so that no route moves: past it the
    JAX package's ``flash_big.supports`` still holds at L 1536 hd 72 and
    L 2048 hd 32, where this route takes 'flash' or 'plain' (ROADMAP C6)."""
    lp = -(-l // TILE) * TILE
    return 128 * lp + 768 * head_dim + 2560 <= SMEM_LIMIT


def fits(l: int, head_dim: int) -> bool:
    """The kernels launch at (L, head_dim) and the route may take them:
    head_dim a multiple of 8 (their 16-byte tile loads) and at most 128,
    both kernels' shared memory within a block's 232,448 B (at every L),
    and L within ``route_window``."""
    return (
        head_dim % 8 == 0 and 0 < head_dim <= MAX_HEAD_DIM
        and fwd_smem_bytes(l, head_dim) <= SMEM_LIMIT
        and bwd_smem_bytes(l, head_dim) <= SMEM_LIMIT
        and route_window(l, head_dim)
    )


def supports(h: int, l: int, head_dim: int) -> bool:
    """True when (heads, seq, head_dim) lies in the JAX ``flash_big.supports``
    window (its ``_plan``: L at least 512 and a multiple of 256, head_dim a
    multiple of 8) and ``fits``, which takes the place of the TPU's VMEM
    budget."""
    return h > 0 and l >= 512 and l % 256 == 0 and fits(l, head_dim)


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
    """(N, L, 3D) packed qkv -> (N, L, D) attention output, differentiable."""
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


packed_attention_big.launches = 0
packed_attention_big_bwd.launches = 0
