"""The gradient of the port's packed attention against the JAX package's.

``maskdit_tpu.ops.flash_batched.packed_attention`` is a ``jax.custom_vjp``
whose backward is the Pallas ``_packed_bwd`` kernel; here it runs in
interpret mode on the CPU, as tests/test_torch_packed_attention.py runs the
forward. The port's side is its ``torch.autograd.Function``, whose CPU
backward is ``packed_attention_bwd_reference``. The CUDA kernel is held to
that plain version by the CUDA-only test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import flash_batched as jax_fb
from maskdit_tpu_torch.ops import flash_batched

# fp32 on both sides, five products of length L (<= 256) summed in other
# orders: |dqkv| reaches ~2 at these inputs and the two differ by < 1e-6
ATOL = 1e-5
SHAPES = [(2, 4, 128, 72), (2, 4, 256, 32)]  # (N, heads, L, hd)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n, h, l, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32)
    dout = rng.normal(size=(n, l, h * hd)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_pallas_kernel(interpret_mode, shape):
    n, h, l, hd = shape
    qkv, dout = _inputs(n, h, l, hd, seed=l + hd)
    scale = hd ** -0.5
    _, vjp = jax.vjp(lambda a: jax_fb.packed_attention(a, h, scale), jnp.asarray(qkv))
    (theirs,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv).requires_grad_()
    flash_batched.packed_attention(x, h, scale).backward(torch.from_numpy(dout))
    assert x.grad.shape == qkv.shape and x.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(theirs), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_reference_matches_autograd_of_forward(dtype):
    """In fp32 the plain backward is the exact gradient of the plain
    forward. In bf16 its rounding points (pb and ds rounded to bf16, as the
    Pallas kernel rounds them) put it within bf16 resolution of autograd."""
    n, h, l, hd = 2, 3, 40, 16
    qkv, dout = _inputs(n, h, l, hd, seed=5)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(dt).requires_grad_()
    g = torch.from_numpy(dout).to(dt)
    flash_batched.packed_attention_reference(x, h, 0.25).backward(g)
    ours = flash_batched.packed_attention_bwd_reference(x.detach(), g, h, 0.25)
    assert ours.dtype == dt
    atol = {"float32": 1e-5, "bfloat16": 5e-2}[dtype]
    np.testing.assert_allclose(ours.float().numpy(), x.grad.float().numpy(), atol=atol)


def test_function_has_a_gradient_and_saves_only_qkv(monkeypatch):
    """The repaired fault: the kernel's output used to be a bare tensor
    filled through ctypes (no grad_fn), so a backward through the model
    dropped every gradient that flows through attention. The Function's
    output has a grad_fn whose only saved tensor is qkv itself."""
    monkeypatch.setattr(flash_batched.packed_attention_bwd, "launches", 0)
    qkv, dout = _inputs(2, 4, 24, 8, seed=6)
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_batched.packed_attention(x, 4, 8 ** -0.5)
    assert out.grad_fn is not None
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == x.data_ptr()
    assert saved[0].shape == x.shape
    # a proj-like consumer hands back a non-contiguous gradient
    w = torch.from_numpy(np.random.default_rng(7).normal(size=(32, 32)).astype(np.float32))
    (out @ w.T).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    assert flash_batched.packed_attention_bwd.launches == 0  # CPU: the plain version


def test_kernel_route_has_a_gradient(monkeypatch):
    """The repaired fault on the kernel's own route. ``_launch`` fills a
    fresh ``torch.empty`` through ctypes, so what it returns has no grad_fn:
    called directly, as ``packed_attention`` called it on a CUDA tensor
    before, it cut every gradient through attention. The kernels need a
    card, so here each launch is stood in for by its plain version, filled
    into a fresh tensor the same way; the Function's kernel route then has a
    gradient, saves only qkv, and hands the backward launch qkv and a
    contiguous gradient of qkv's dtype."""
    h, scale = 4, 8 ** -0.5
    seen = []

    def launch(qkv, num_heads, sc):
        out = torch.empty(qkv.shape[:2] + (qkv.shape[2] // 3,), dtype=qkv.dtype)
        with torch.no_grad():
            out.copy_(flash_batched.packed_attention_reference(qkv, num_heads, sc))
        return out

    def launch_bwd(qkv, dout, num_heads, sc):
        seen.append((qkv, dout.dtype, dout.is_contiguous()))
        return flash_batched.packed_attention_bwd_reference(qkv, dout, num_heads, sc)

    monkeypatch.setattr(flash_batched, "_launch", launch)
    monkeypatch.setattr(flash_batched, "_launch_bwd", launch_bwd)
    qkv, dout = _inputs(2, h, 24, 8, seed=10)
    x = torch.from_numpy(qkv).requires_grad_()
    assert launch(x, h, scale).grad_fn is None  # the old path: no gradient
    out = flash_batched.AttentionFunction.apply(x, h, scale, flash_batched._launch,
                                                flash_batched._launch_bwd)
    assert out.grad_fn is not None
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == [x.data_ptr()]
    # a permuted consumer hands back a non-contiguous gradient
    g = torch.from_numpy(dout).permute(2, 0, 1).contiguous()
    (out.permute(2, 0, 1) * g).sum().backward()
    assert len(seen) == 1 and seen[0][0].data_ptr() == x.data_ptr()
    assert seen[0][1] == torch.float32 and seen[0][2]
    ref = torch.from_numpy(qkv).requires_grad_()
    flash_batched.packed_attention_reference(ref, h, scale).backward(torch.from_numpy(dout))
    torch.testing.assert_close(x.grad, ref.grad, rtol=1e-5, atol=1e-6)


def test_plain_function_matches_default_on_cpu():
    qkv, dout = _inputs(2, 4, 24, 8, seed=8)
    grads = []
    for fn in (flash_batched.packed_attention, flash_batched.packed_attention_plain):
        x = torch.from_numpy(qkv).requires_grad_()
        fn(x, 4, 0.3).backward(torch.from_numpy(dout))
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 16, 128, 72), (32, 16, 256, 32), (3, 4, 77, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_bwd_kernel_matches_plain_version(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    n, h, l, hd = shape
    qkv, dout = _inputs(n, h, l, hd, seed=9)
    dt = getattr(torch, dtype)
    x, g = torch.from_numpy(qkv).cuda().to(dt), torch.from_numpy(dout).cuda().to(dt)
    before = flash_batched.packed_attention_bwd.launches
    ours = flash_batched.packed_attention_bwd(x, g, h, hd ** -0.5)
    torch.cuda.synchronize()
    assert flash_batched.packed_attention_bwd.launches == before + 1
    ref = flash_batched.packed_attention_bwd_reference(x, g, h, hd ** -0.5).float()
    # fp32: summation order only; bf16: one rounding of ds, pb or the
    # output may differ, relative to the gradient's scale
    rel = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    err = (ours.float() - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), err
