"""The port's blocked attention (ops/flash_big.py) against the JAX package's.

``maskdit_tpu.ops.flash_big.packed_attention_big`` is a ``jax.custom_vjp``
whose forward and backward are the Pallas kernels ``_big_fwd`` and
``_big_bwd``; here they run in interpret mode on the CPU, as
tests/test_torch_packed_attention_grad.py runs flash_batched's. The port's
side is its ``torch.autograd.Function``, whose CPU route is the plain
versions. The CUDA kernels are held to those plain versions by the
CUDA-only test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import flash_big as jax_big
from maskdit_tpu_torch.ops import flash_batched, flash_big

# fp32 on both sides; the products run over L <= 1024 keys summed in other
# orders: outputs agree to ~1e-6 and gradients (|dqkv| up to ~3 here) to
# ~2e-6
FWD_ATOL, BWD_ATOL = 1e-5, 2e-5
# (N, L, heads, hd): the smallest L the kernel takes, the L 768 chunk-tail
# regression (two query chunks of 256 plus a third; a bq of 512 would leave
# a tail unwritten) and the decoder's L 1024 at hd 32
SHAPES = [(1, 512, 2, 8), (1, 768, 2, 8), (1, 1024, 2, 32)]


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(n, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32)
    dout = rng.normal(size=(n, l, h * hd)).astype(np.float32)
    return qkv, dout


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_and_backward_match_pallas_kernels(interpret_mode, shape):
    n, l, h, hd = shape
    qkv, dout = _inputs(n, l, h, hd, seed=l + hd)
    scale = hd ** -0.5
    theirs, vjp = jax.vjp(lambda a: jax_big.packed_attention_big(a, h, scale), jnp.asarray(qkv))
    (dtheirs,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv).requires_grad_()
    ours = flash_big.packed_attention_big(x, h, scale)
    assert ours.shape == (n, l, h * hd) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=FWD_ATOL)
    ours.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dtheirs), atol=BWD_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_q", [256, 100])
def test_chunked_plain_versions_match_whole_rows(dtype, block_q):
    """The plain versions' query chunks change nothing: each chunk's rows
    see all keys, the rounding points are those of flash_batched's plain
    versions, and dk/dv are summed in fp32 before one rounding. fp32 agrees
    to summation order; bf16 to one rounding of dk/dv (the unchunked
    version rounds the same fp32 sum, in another order)."""
    n, l, h, hd = 2, 300, 3, 16
    qkv, dout = _inputs(n, l, h, hd, seed=3)
    dt = getattr(torch, dtype)
    x, g = torch.from_numpy(qkv).to(dt), torch.from_numpy(dout).to(dt)
    fwd = flash_big.packed_attention_big_reference(x, h, 0.3, block_q=block_q)
    bwd = flash_big.packed_attention_big_bwd_reference(x, g, h, 0.3, block_q=block_q)
    assert fwd.dtype == bwd.dtype == dt and bwd.shape == x.shape
    tol = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}[dtype]
    torch.testing.assert_close(fwd, flash_batched.packed_attention_reference(x, h, 0.3), **tol)
    torch.testing.assert_close(bwd, flash_batched.packed_attention_bwd_reference(x, g, h, 0.3),
                               **tol)


def test_function_saves_only_qkv_and_plain_matches_default_on_cpu(monkeypatch):
    monkeypatch.setattr(flash_big.packed_attention_big, "launches", 0)
    monkeypatch.setattr(flash_big.packed_attention_big_bwd, "launches", 0)
    qkv, dout = _inputs(2, 512, 2, 8, seed=6)
    grads = []
    for fn in (flash_big.packed_attention_big, flash_big.packed_attention_big_plain):
        x = torch.from_numpy(qkv).requires_grad_()
        out = fn(x, 2, 0.3)
        assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == [x.data_ptr()]
        # a permuted consumer hands back a non-contiguous gradient
        g = torch.from_numpy(dout).permute(2, 0, 1).contiguous()
        (out.permute(2, 0, 1) * g).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    # the CPU takes the plain versions: no kernel was launched
    assert flash_big.packed_attention_big.launches == 0
    assert flash_big.packed_attention_big_bwd.launches == 0


def test_kernel_route_hands_the_launches_qkv_and_a_contiguous_gradient(monkeypatch):
    """The Function's kernel route, with each launch stood in for by its
    plain version (the kernels need a card): a gradient flows, only qkv is
    saved, and the backward launch gets qkv and a contiguous gradient of
    qkv's dtype."""
    h, scale = 2, 8 ** -0.5
    seen = []

    def launch(qkv, num_heads, sc):
        out = torch.empty(qkv.shape[:2] + (qkv.shape[2] // 3,), dtype=qkv.dtype)
        with torch.no_grad():
            out.copy_(flash_big.packed_attention_big_reference(qkv, num_heads, sc))
        return out

    def launch_bwd(qkv, dout, num_heads, sc):
        seen.append((qkv.data_ptr(), dout.dtype, dout.is_contiguous()))
        return flash_big.packed_attention_big_bwd_reference(qkv, dout, num_heads, sc)

    monkeypatch.setattr(flash_big, "_launch", launch)
    monkeypatch.setattr(flash_big, "_launch_bwd", launch_bwd)
    qkv, dout = _inputs(1, 512, h, 8, seed=10)
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_batched.AttentionFunction.apply(x, h, scale, flash_big._launch,
                                                flash_big._launch_bwd)
    g = torch.from_numpy(dout).permute(2, 0, 1).contiguous()
    (out.permute(2, 0, 1) * g).sum().backward()
    assert seen == [(x.data_ptr(), torch.float32, True)]
    ref = torch.from_numpy(qkv).requires_grad_()
    flash_batched.packed_attention_reference(ref, h, scale).backward(torch.from_numpy(dout))
    torch.testing.assert_close(x.grad, ref.grad, rtol=1e-5, atol=1e-6)


def test_wrappers_raise_without_a_kernel_for_the_tensor():
    """A wrapper takes its plain version only for a CPU tensor; the launch
    path raises on what its kernel does not take."""
    x = torch.zeros(1, 512, 3 * 2 * 8)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_big._launch(x, 2, 0.3)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_big._launch_bwd(x, torch.zeros(1, 512, 16), 2, 0.3)


@pytest.mark.parametrize("h,l,hd", [
    (16, 512, 72), (16, 1024, 32), (16, 1024, 72), (16, 128, 72), (16, 640, 72),
    (16, 512, 12), (2, 768, 8), (12, 1024, 64), (6, 512, 64), (16, 256, 72),
])
def test_supports_window_is_the_jax_packages(h, l, hd):
    """The shape window of the JAX flash_big.supports (tests/test_flash.py
    pins it) at every shape that fits the card's shared memory."""
    assert flash_big.supports(h, l, hd) == jax_big.supports(h, l, hd)


@pytest.mark.parametrize("l,hd,fits", [
    (256, 72, True), (128, 72, True), (777, 40, True), (1024, 128, True),
    (256, 12, False), (256, 136, False), (2048, 72, False),
])
def test_kernels_fit_any_l_with_an_8_aligned_head_dim(l, hd, fits):
    """``fits``: where the kernels launch, at any L (the route sends them the
    whole-row shapes whose backward does not fit, L 256 at hd 72);
    ``supports`` adds the JAX package's window."""
    assert flash_big.fits(l, hd) == fits
    assert not flash_big.supports(16, l, hd) or fits


def test_shared_memory_formulas():
    """What the kernel sources lay out, as the module computes it: the
    512-px shapes fit a block's 232,448 B (one forward block per SM at
    L 1024, two at L 512); L 2048 does not, so supports() refuses it."""
    assert flash_big.fwd_smem_bytes(1024, 72) == 179712
    assert flash_big.fwd_smem_bytes(512, 72) == 114176
    assert flash_big.fwd_smem_bytes(1024, 32) == 154112
    assert flash_big.bwd_smem_bytes(1024, 72) == 188928
    assert flash_big.bwd_smem_bytes(512, 72) == 123392
    assert flash_big.bwd_smem_bytes(1024, 128) == 231936
    assert flash_big.fwd_smem_bytes(1000, 72) == flash_big.fwd_smem_bytes(1024, 72)
    assert not flash_big.supports(16, 2048, 72)


def _variant_bwd(qkv, dout, h, scale, acc=torch.float64, round_p=True, round_ds=True):
    """The backward of the plain version with the products summed in
    ``acc``, and its p (for o and dv) or ds rounding points optionally
    dropped: (out, dqkv), both rounded to qkv's dtype."""
    n, l, three_d = qkv.shape
    dt = qkv.dtype
    hd = three_d // 3 // h
    q, k, v = (t.to(acc) for t in flash_big._heads(qkv, h))
    do = dout.reshape(n, l, h, hd).permute(0, 2, 1, 3).to(acc)
    s = q @ k.transpose(-1, -2) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    pb = p.to(dt).to(acc) if round_p else p
    o = pb @ v
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True)) * scale
    ds = ds.to(dt).to(acc) if round_ds else ds
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q, pb.transpose(-1, -2) @ do])
    out = o.permute(0, 2, 1, 3).reshape(n, l, three_d // 3)
    return out.to(dt), dqkv.permute(1, 3, 0, 2, 4).reshape(n, l, three_d).to(dt)


def _share(a, b):
    return ((a.float() - b.float()).abs() > 0).float().mean().item()


def test_bf16_mismatch_share_separates_rounding_faults():
    """The premise of chip_smoke.py's BF16_MISMATCH_BOUND (5%): in bf16 a
    kernel that sums in another order flips few elements of the plain
    version's output and gradient (here fp64 sums: under 0.5%), while one
    that moves or drops a rounding point flips many (over 20%), though the
    max error of both is about one bf16 ulp."""
    h, hd = 2, 72
    qkv, dout = _inputs(1, 512, h, hd, seed=11)
    x, g = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(dout).bfloat16()
    scale = hd ** -0.5
    ref_out = flash_big.packed_attention_big_reference(x, h, scale)
    ref_grad = flash_big.packed_attention_big_bwd_reference(x, g, h, scale)
    out, grad = _variant_bwd(x, g, h, scale)
    assert _share(out, ref_out) < 0.005 and _share(grad, ref_grad) < 0.005
    for fault in (dict(round_p=False), dict(round_ds=False)):
        out, grad = _variant_bwd(x, g, h, scale, **fault)
        assert _share(grad, ref_grad) > 0.2, fault
    assert _share(_variant_bwd(x, g, h, scale, round_p=False)[0], ref_out) > 0.2
    # p rounded before normalising instead of after
    q, k, v = flash_big._heads(x, h)
    s = q @ k.transpose(-1, -2) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    early = (e.bfloat16().float() / e.sum(-1, keepdim=True)) @ v
    early = early.bfloat16().permute(0, 2, 1, 3).reshape(ref_out.shape)
    assert _share(early, ref_out) > 0.2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1024, 16, 72), (4, 512, 16, 72), (2, 1024, 16, 32),
                                   (3, 777, 4, 40)], ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernels_match_plain_versions(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    n, l, h, hd = shape
    qkv, dout = _inputs(n, l, h, hd, seed=9)
    dt = getattr(torch, dtype)
    x, g = torch.from_numpy(qkv).cuda().to(dt), torch.from_numpy(dout).cuda().to(dt)
    before = (flash_big.packed_attention_big.launches, flash_big.packed_attention_big_bwd.launches)
    out = flash_big._launch(x, h, hd ** -0.5)
    dqkv = flash_big.packed_attention_big_bwd(x, g, h, hd ** -0.5)
    torch.cuda.synchronize()
    assert (flash_big.packed_attention_big.launches,
            flash_big.packed_attention_big_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref = flash_big.packed_attention_big_reference(x, h, hd ** -0.5).float()
    dref = flash_big.packed_attention_big_bwd_reference(x, g, h, hd ** -0.5).float()
    # relative to each result's largest value: fp32 differs by summation
    # order; bf16 by one rounding of p, ds or the output (one bf16 ulp is at
    # most 2^-7 of the largest value), and only at a small share of the
    # elements: a rounding point moved or dropped changes a quarter to a
    # half of them (chip_smoke.py's BF16_MISMATCH_BOUND)
    fwd_rel = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    bwd_rel = {"float32": 1e-5, "bfloat16": 2e-2}[dtype]
    for got, want, rel in ((out, ref, fwd_rel), (dqkv, dref, bwd_rel)):
        diff = (got.float() - want).abs()
        assert diff.max().item() <= rel * want.abs().max().item()
        if dtype == "bfloat16":
            assert (diff > 0).float().mean().item() <= 0.05
