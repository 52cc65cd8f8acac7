"""The port's ops/flash.py against the JAX package's.

``maskdit_tpu.ops.flash`` is a ``jax.custom_vjp`` whose forward
(``_flash_fwd``) and backward (``_flash_bwd``) are Pallas kernels; here they
run in interpret mode on the CPU, as tests/test_flash.py runs them. The
port's plain versions follow their bodies step by step, and its
``FlashFunction`` takes them on a CPU tensor. The CUDA kernels are held to
the plain versions by the CUDA-only test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import flash as jax_flash
from maskdit_tpu_torch.ops import flash, flash_batched

# relative to max|ref|: fp32 differs by summation order (~6e-7 measured);
# bf16 by one rounding of p / l, of o or of a gradient, one bf16 ulp (at most
# 2^-7 of the largest value), and only at a small share of the elements
# (under 0.04% measured; a moved or dropped rounding point changes over 5%)
REL = {"float32": 1e-5, "bfloat16": 1e-2}
BF16_SHARE = 0.005
# (N*H, L, hd): XL/2's encoder head dim, the decoder's and the largest
# kernel head dim at the smallest L of the window, and an L of two tiles
SHAPES = [(4, 128, 32), (4, 128, 72), (4, 128, 128), (8, 256, 72)]
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(shape, seed, count=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    jx = [jnp.asarray(a).astype(JAX_DTYPES[dtype]) for a in arrays]
    return jx, [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                for a in jx]


def _assert_close(got, want, dtype, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert diff.max() <= REL[dtype] * np.abs(want).max(), (what, diff.max())
    if dtype == "bfloat16":
        assert (diff > 0).mean() <= BF16_SHARE, (what, (diff > 0).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_forward_matches_pallas_fwd(interpret_mode, shape, dtype):
    """o and lse of ``flash_fwd_reference`` against ``_flash_fwd``; lse is
    fp32 in both (fp32 sums in another order: 1e-5 absolute)."""
    (q, k, v), (tq, tk, tv) = _both(_inputs(shape, sum(shape), 3), dtype)
    scale = shape[-1] ** -0.5
    o, residuals = jax_flash._flash_fwd(q, k, v, scale)
    to, tlse = flash.flash_fwd_reference(tq, tk, tv, scale)
    assert to.dtype == tq.dtype and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == residuals[4].shape == (shape[0], 1, shape[1])
    _assert_close(to, o.astype(jnp.float32), dtype, "o")
    np.testing.assert_allclose(tlse.numpy(), np.asarray(residuals[4]), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_pallas_bwd(interpret_mode, shape, dtype):
    """dq, dk, dv of ``flash_bwd_reference`` against ``_flash_bwd`` on the
    same residuals (the JAX forward's stored o and its lse) and cotangent."""
    (q, k, v, g), (tq, tk, tv, tg) = _both(_inputs(shape, sum(shape) + 1), dtype)
    scale = shape[-1] ** -0.5
    _, residuals = jax_flash._flash_fwd(q, k, v, scale)
    theirs = jax_flash._flash_bwd(scale, residuals, g)
    o = torch.from_numpy(np.array(residuals[3].astype(jnp.float32))).to(tq.dtype)
    lse = torch.from_numpy(np.array(residuals[4]))
    ours = flash.flash_bwd_reference(tq, tk, tv, o, lse, tg, scale)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        assert a.dtype == tq.dtype
        _assert_close(a, b.astype(jnp.float32), dtype, name)


@pytest.mark.parametrize("shape", [(1, 2, 128, 32), (2, 2, 256, 72)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_mha_value_and_gradients_match_jax(interpret_mode, shape):
    """``flash_mha`` through autograd against ``jax.grad`` of the JAX
    ``flash_mha`` (its custom VJP), fp32, loss sum(sin(o)) as
    tests/test_flash.py takes it: summation order only."""
    q, k, v = _inputs(shape, 11, 3)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash.flash_mha(q, k, v)))

    theirs = jax_flash.flash_mha(*(jnp.asarray(a) for a in (q, k, v)))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ours = flash.flash_mha(tq, tk, tv)
    assert ours.shape == shape
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=2e-6)
    torch.sin(ours).sum().backward()
    for name, t, want in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=5e-6, err_msg=name)


def test_flash_mha_falls_back_outside_the_window():
    """L not a multiple of 128 (or above 2048): the plain mha_reference, as
    the JAX ``flash_mha`` falls back; nothing is counted."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 100, 32), 4, 3))
    torch.testing.assert_close(flash.flash_mha(q, k, v),
                               flash.mha_reference(q, k, v), rtol=0, atol=0)


def test_supports_is_the_jax_window():
    for l in range(100, 2177):
        assert flash.supports(l) == jax_flash.supports(l), l


def test_bf16_rounding_points_differ_from_the_packed_backward():
    """Why the flash route has kernels of its own: in bf16, #6's plain
    backward (fp32 p and ds, delta from the stored o) and the packed
    backward's plain version (p and ds rounded, delta from the recomputed
    o) differ in far more of dq's elements than chip_smoke.py's
    BF16_MISMATCH_BOUND (5%) allows a kernel to differ from its plain
    version."""
    n, h, l, hd = 2, 4, 128, 32
    q, k, v, g = (torch.from_numpy(a).bfloat16() for a in _inputs((n, h, l, hd), 21))
    scale = hd ** -0.5
    flat = [t.reshape(n * h, l, hd) for t in (q, k, v, g)]
    o, lse = flash.flash_fwd_reference(*flat[:3], scale)
    dq = flash.flash_bwd_reference(*flat[:3], o, lse, flat[3], scale)[0]

    def pack(t):
        return t.permute(0, 2, 1, 3).reshape(n, l, h * hd)

    dqkv = flash_batched.packed_attention_bwd_reference(
        torch.cat([pack(q), pack(k), pack(v)], dim=-1), pack(g), h, scale)
    packed_dq = dqkv[..., :h * hd].reshape(n, l, h, hd).permute(0, 2, 1, 3)
    share = (dq.reshape(n, h, l, hd).float() != packed_dq.float()).float().mean().item()
    assert share > 0.2, share


def test_function_saves_the_five_residuals_and_plain_matches_default_on_cpu(monkeypatch):
    monkeypatch.setattr(flash.flash_fwd, "launches", 0)
    monkeypatch.setattr(flash.flash_bwd, "launches", 0)
    arrays = _inputs((2, 2, 128, 16), 6)
    grads = []
    for fn in (flash.flash_mha, flash.flash_mha_plain):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
        out = fn(q, k, v)
        # the Function's node, under the (N*H) -> (N, H) reshape
        saved = out.grad_fn.next_functions[0][0].saved_tensors
        assert [tuple(t.shape) for t in saved] == [(4, 128, 16)] * 4 + [(4, 1, 128)]
        # a permuted consumer hands back a non-contiguous gradient
        (out.permute(3, 0, 1, 2) * torch.from_numpy(arrays[3]).permute(3, 0, 1, 2)).sum().backward()
        grads.append(torch.cat([t.grad for t in (q, k, v)]))
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    # the CPU takes the plain versions: no kernel was launched
    assert flash.flash_fwd.launches == flash.flash_bwd.launches == 0


def test_wrappers_raise_without_a_kernel_for_the_tensor():
    """A wrapper takes its plain version only for a CPU tensor; the launch
    path raises on what its kernels do not take, and a head dim they
    cannot load is NotImplementedError."""
    x = torch.zeros(2, 128, 32)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash._launch_fwd(x, x, x, 0.2)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash._launch_bwd(x, x, x, x, torch.zeros(2, 1, 128), x, 0.2)
    for hd in (20, 136):
        with pytest.raises(NotImplementedError, match=f"not {hd}"):
            flash.check_head_dim("flash_fwd", (2, 128, hd))
    flash.check_head_dim("flash_fwd", (2, 128, 72))


def test_shared_memory_covers_the_whole_window():
    """What csrc/flash_fwd.cu and flash_bwd.cu lay out, as the module
    computes it: 32 query rows per forward block up to L 1408 at hd 72, 16
    above (L 2048 alone would take 256 KB of logits at 32 rows); the
    backward's shared memory does not grow with L. Every L of the window
    launches at every model head dim and at 128."""
    assert flash.fwd_smem_bytes(512, 72, 32) == 114176
    assert flash.fwd_smem_bytes(1024, 32, 32) == 154112
    assert flash.fwd_smem_bytes(2048, 72, 16) == 175104
    assert flash.bwd_smem_bytes(72) == 109568
    assert flash.bwd_smem_bytes(32) == 58368
    assert flash.fwd_block_rows(1408, 72) == 32 and flash.fwd_block_rows(1536, 72) == 16
    for l in range(128, 2049, 128):
        for hd in (32, 64, 72, 128):
            rows = flash.fwd_block_rows(l, hd)
            assert rows in flash.BLOCK_ROWS and flash.fwd_smem_bytes(l, hd, rows) <= 232448
    assert flash.bwd_smem_bytes(128) <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 512, 72), (32, 1024, 32), (8, 2048, 72), (12, 384, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernels_match_plain_versions(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    q, k, v, g = (torch.from_numpy(a).cuda().to(getattr(torch, dtype))
                  for a in _inputs(shape, 9))
    scale = shape[-1] ** -0.5
    before = (flash.flash_fwd.launches, flash.flash_bwd.launches)
    o, lse = flash.flash_fwd(q, k, v, scale)
    grads = flash.flash_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    assert (flash.flash_fwd.launches, flash.flash_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
    ref_grads = flash.flash_bwd_reference(q, k, v, o, lse, g, scale)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    bwd_rel = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    for got, want, rel in [(o, ref_o, REL[dtype])] + [(a, b, bwd_rel)
                                                      for a, b in zip(grads, ref_grads)]:
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= rel * want.float().abs().max().item()
        if dtype == "bfloat16":
            assert (diff > 0).float().mean().item() <= 0.05
