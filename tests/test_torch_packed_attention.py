"""Packed attention of the PyTorch port against the JAX Pallas kernel.

The JAX side runs the real Pallas kernel in interpret mode on the CPU (as
tests/test_flash.py does); the port's side is its plain PyTorch version,
which the wrapper takes for CPU tensors. The CUDA kernel itself is held to
that plain version by the CUDA-only test here and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import flash_batched as jax_fb
from maskdit_tpu_torch.ops import flash_batched

# fp32: both sides accumulate in fp32, in different orders; bf16: one
# rounding of the probabilities and one of the output differ
ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
SHAPES = [(2, 4, 128, 72), (2, 4, 256, 32)]  # (N, heads, L, hd)


@pytest.fixture
def interpret_mode():
    """Run Pallas kernels interpreted (no TPU here)."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(n, h, l, hd, seed):
    return np.random.default_rng(seed).normal(size=(n, l, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_packed_attention_matches_pallas_kernel(interpret_mode, shape, dtype):
    n, h, l, hd = shape
    qkv = _qkv(n, h, l, hd, seed=l + hd)
    scale = hd ** -0.5
    ours = flash_batched.packed_attention(
        torch.from_numpy(qkv).to(getattr(torch, dtype)), h, scale
    )
    theirs = jax_fb.packed_attention(
        jnp.asarray(qkv).astype(getattr(jnp, dtype)), h, scale
    )
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (n, l, h * hd)
    np.testing.assert_allclose(
        ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
        atol=ATOL[dtype],
    )


def test_cpu_tensor_takes_plain_version(monkeypatch):
    """A CPU tensor never launches the kernel, and gets exactly the plain
    version's result."""
    monkeypatch.setattr(flash_batched.packed_attention, "launches", 0)
    qkv = torch.from_numpy(_qkv(2, 4, 40, 16, seed=1))
    out = flash_batched.packed_attention(qkv, 4, 0.25)
    ref = flash_batched.packed_attention_reference(qkv, 4, 0.25)
    assert flash_batched.packed_attention.launches == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_reference_matches_per_head_softmax():
    """The plain version's packing: head h of q, k, v sits at features
    [h*hd, (h+1)*hd) of each third of the qkv row."""
    n, h, l, hd = 2, 3, 10, 8
    qkv = torch.from_numpy(_qkv(n, h, l, hd, seed=2))
    out = flash_batched.packed_attention_reference(qkv, h, 0.3)
    d = h * hd
    for head in range(h):
        cols = slice(head * hd, (head + 1) * hd)
        q, k, v = qkv[..., :d][..., cols], qkv[..., d:2 * d][..., cols], qkv[..., 2 * d:][..., cols]
        p = torch.softmax(q @ k.transpose(1, 2) * 0.3, dim=-1)
        torch.testing.assert_close(out[..., cols], p @ v, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 16, 256, 72), (16, 16, 256, 32), (16, 16, 128, 72), (3, 4, 77, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    n, h, l, hd = shape
    qkv = torch.from_numpy(_qkv(n, h, l, hd, seed=3)).cuda().to(getattr(torch, dtype))
    before = flash_batched.packed_attention.launches
    out = flash_batched.packed_attention(qkv, h, hd ** -0.5)
    torch.cuda.synchronize()
    assert flash_batched.packed_attention.launches == before + 1
    ref = flash_batched.packed_attention_reference(qkv, h, hd ** -0.5)
    # bf16: the two round the probabilities and the output at different
    # sums; fp32: summation order, and on the tensor cores the six-term
    # products' dropped terms (~2^-24 of each product)
    atol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), atol=atol)
