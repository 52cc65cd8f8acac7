"""Packed multi-head attention: (N, L, 3D) qkv -> (N, L, D).

Counterpart of maskdit_tpu/ops/flash_batched.py::packed_attention (forward).
The qkv Dense emits [q | k | v] along features, head h at [h*hd, (h+1)*hd)
of each third. ``packed_attention`` is the entry point the model calls:

  * a CPU tensor goes to ``packed_attention_reference``, the plain PyTorch
    version the tests hold the kernel to;
  * a CUDA tensor launches the hand-written kernel in
    ``csrc/packed_attention_fwd.cu`` (which replaces the Pallas
    ``_packed_fwd``), or raises.

``packed_attention.launches`` counts kernel launches and nothing else, so a
run can show that it went through the kernel. The backward kernel arrives
with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maskdit_tpu_torch.ops import build
from maskdit_tpu_torch.ops.attention import mha_reference

KERNEL = "packed_attention_fwd"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
MAX_HEAD_DIM = 128


def packed_attention_reference(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    heads = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = mha_reference(heads[0], heads[1], heads[2], scale)
    return o.permute(0, 2, 1, 3).reshape(n, l, d)


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


def _launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    if qkv.device.type != "cuda":
        raise ValueError(f"packed_attention: no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"packed_attention: dtype {qkv.dtype} (takes bfloat16 or float32)"
        )
    if qkv.dim() != 3 or qkv.shape[2] % (3 * num_heads):
        raise ValueError(
            f"packed_attention: qkv shape {tuple(qkv.shape)} is not "
            f"(N, L, 3 * {num_heads} * hd)"
        )
    if not qkv.is_contiguous():
        raise ValueError("packed_attention: qkv must be contiguous")
    n, l, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"packed_attention: head dim {hd} > {MAX_HEAD_DIM}")
    lib = _library()
    out = torch.empty((n, l, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.packed_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), n, l, num_heads, hd, scale,
            _DTYPE_CODES[qkv.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        smem = lib.packed_attention_fwd_smem_bytes(l, hd, qkv.element_size())
        raise RuntimeError(
            f"packed_attention kernel launch failed: "
            f"{lib.packed_attention_error_string(err).decode()} "
            f"(N={n}, L={l}, H={num_heads}, hd={hd}, {qkv.dtype}, "
            f"{smem} B shared memory per block)"
        )
    packed_attention.launches += 1
    return out


def packed_attention(
    qkv: torch.Tensor, num_heads: int, scale: float
) -> torch.Tensor:
    """(N, L, 3D) packed qkv -> (N, L, D) attention output."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, num_heads, scale)
    return _launch(qkv, num_heads, scale)


packed_attention.launches = 0
