"""The port's blocked attention (ops/flash_big.py) against the JAX package's.

``maskdit_tpu.ops.flash_big.packed_attention_big`` is a ``jax.custom_vjp``
whose forward and backward are the Pallas kernels ``_big_fwd`` and
``_big_bwd``; here they run in interpret mode on the CPU, as
tests/test_torch_packed_attention_grad.py runs flash_batched's. The port's
side is its ``torch.autograd.Function``, whose CPU route is the plain
versions. The CUDA kernels are held to those plain versions by the
CUDA-only test here and by chip_smoke.py.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from maskdit_tpu.ops import flash_batched as jax_fb
from maskdit_tpu.ops import flash_big as jax_big
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big

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
    (16, 1536, 72), (16, 2048, 32), (16, 2048, 72),
])
def test_supports_window_is_the_jax_packages(h, l, hd):
    """The shape window of the JAX flash_big.supports (tests/test_flash.py
    pins it) at every shape that fits the card's shared memory, which at
    a head dim that is a multiple of 8 is every L."""
    assert flash_big.supports(h, l, hd) == jax_big.supports(h, l, hd)


@pytest.mark.parametrize("h,l,hd,forward,backward", [
    (16, 128, 72, True, True), (16, 256, 32, True, True), (16, 256, 72, True, True),
    (6, 512, 64, True, True), (16, 512, 72, True, True), (16, 192, 72, True, True),
    (16, 1024, 72, False, False), (2, 640, 128, False, False), (1, 640, 20, True, False),
    (2, 768, 8, True, True),
])
def test_whole_row_window_is_the_jax_packages(h, l, hd, forward, backward):
    """``flash_batched.supports`` is the JAX ``flash_batched.supports``
    (tests/test_flash.py pins it) where the whole-row kernels launch in both
    types, the forward alone or with the backward: not at L 1024, hd 72 or
    L 640, hd 128, where the bf16 forward's logits row and its FMA layout
    outgrow a block, nor with a backward at L 640, hd 20, whose FMA
    backward does."""
    assert flash_batched.fits(l, hd, False) == forward
    assert flash_batched.fits(l, hd, True) == backward
    assert flash_batched.supports(h, l, hd) == (jax_fb.supports(h, l, hd) and backward)
    assert flash_batched.supports(h, l, hd, backward=False) == (jax_fb.supports(h, l, hd)
                                                                and forward)


@pytest.mark.parametrize("l,hd,fits", [
    (256, 72, True), (128, 72, True), (777, 40, True), (1024, 128, True),
    (256, 12, False), (256, 136, False), (2048, 72, True),
])
def test_kernels_fit_any_l_with_an_8_aligned_head_dim(l, hd, fits):
    """``fits``: where the kernels launch, at any L at a head dim they take
    (a multiple of 8, at most 128: both layouts fit at every L, L 2048 at
    hd 72 too); ``supports`` adds the JAX package's window."""
    assert flash_big.fits(l, hd) == fits
    assert not flash_big.supports(16, l, hd) or fits
    if hd % 8 == 0 and hd <= 128:
        assert flash_big.fwd_smem_bytes(l, hd) <= flash_batched.SMEM_LIMIT
        assert flash_big.bwd_smem_bytes(l, hd) <= flash_batched.SMEM_LIMIT
        assert flash_big.fits(l, hd)


def test_shared_memory_formulas():
    """What the kernel sources lay out, as the module computes it: fp32
    (csrc/attention_fp32_mma.cuh) and bf16 the same at every L; at hd 72
    two blocks share an SM in the forward and in both backward kernels.
    supports() is the JAX ``_plan`` window, which the layouts fit at every
    L: it holds at L 1536 hd 72 and L 2048 hd 32 (where the first fp32
    kernels' layouts did not fit), and refuses L 2048 at hd 72."""
    assert flash_big.fwd_smem_bytes(1024, 72) == 96256
    assert flash_big.fwd_smem_bytes(512, 72) == 96256
    assert flash_big.fwd_smem_bytes(1024, 32) == 47104
    assert flash_big.bwd_smem_bytes(1024, 72) == 114688
    assert flash_big.bwd_smem_bytes(512, 72) == 114688
    assert flash_big.bwd_smem_bytes(1024, 128) == 204800
    assert flash_big.fwd_smem_bytes(1000, 72) == flash_big.fwd_smem_bytes(1024, 72)
    assert not flash_big.supports(16, 2048, 72)
    assert flash_big.bwd_smem_bytes(1024, 72, 4) == flash_big.bwd_smem_bytes(1024, 72)
    for hd in (32, 72):
        assert 2 * (flash_big.fwd_smem_bytes(1024, hd) + 1024) <= 233472
        assert 2 * (flash_big.bwd_smem_bytes(1024, hd) + 1024) <= 233472
    assert [flash_batched.fp32_key_depth(hd) for hd in (8, 32, 40, 72, 128)] == [2, 2, 2, 1, 1]
    for hd in range(8, 129, 8):
        assert len({flash_big.fwd_smem_bytes(l, hd) for l in (64, 777, 4096)}) == 1
        assert len({flash_big.bwd_smem_bytes(l, hd) for l in (64, 777, 4096)}) == 1
    assert flash_big.supports(16, 1536, 72) and flash_big.supports(16, 2048, 32)
    assert jax_big.supports(16, 1536, 72) and jax_big.supports(16, 2048, 32)
    assert not jax_big.supports(16, 2048, 72)
    # bf16 runs the tensor-core forward (csrc/attention_fwd_mma.cuh): four
    # bf16 [64][hd16 + 8] tiles, hd16 = hd padded to 16, the same at every L,
    # so four blocks fit an SM at hd 72; fits() reads the fp32 layouts
    assert flash_big.fwd_smem_bytes(1024, 72, 2) == 45056
    assert flash_big.fwd_smem_bytes(512, 72, 2) == 45056
    assert flash_big.fwd_smem_bytes(1024, 32, 2) == 20480
    assert flash_big.fwd_smem_bytes(777, 40, 2) == 28672
    assert flash_big.fwd_smem_bytes(2048, 128, 2) == 69632
    assert flash_big.fwd_smem_bytes(1024, 72, 4) == flash_big.fwd_smem_bytes(1024, 72)
    for hd in range(8, 129, 8):
        assert flash_big.mma_fwd_smem_bytes(hd) == 4 * 64 * (-(-hd // 16) * 16 + 8) * 2
        assert flash_big.fwd_smem_bytes(1024, hd, 2) < flash_big.fwd_smem_bytes(64, hd, 4)


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bf16_backward_shared_memory_does_not_grow_with_l(hd):
    """The bf16 tensor-core backward's shared memory
    (csrc/attention_bwd_mma.cuh, both backwards): the key kernel's six
    bf16 [64][hd16 + 8] tiles (its K and V, the Q and dO rings) and its pb
    and ds tiles, bf16 [64][72]; the query kernel's four tiles are fewer.
    The same at every L and within a block's limit at every head dim, as
    the fp32 tensor-core kernels' (``mma6``) are."""
    hd16 = -(-hd // 16) * 16
    want = 6 * 64 * (hd16 + 8) * 2 + 2 * 64 * 72 * 2
    assert flash_batched.mma_bwd_smem_bytes(hd) == want > 4 * 64 * (hd16 + 8) * 2
    for l in (64, 128, 256, 512, 777, 1024, 2048, 4096):
        assert flash_big.bwd_smem_bytes(l, hd, 2) == want <= flash_batched.SMEM_LIMIT
        assert flash_batched.bwd_smem_bytes(l, hd, 2) == want
    assert flash_batched.bwd_kernel(torch.bfloat16, hd) == "mma"
    assert flash_batched.bwd_kernel(torch.float32, hd) == "mma6"
    # at hd 72: 86,016 B (two blocks per SM), where the whole-row fp32-FMA
    # layout needed 236,544 B at L 256
    assert flash_batched.mma_bwd_smem_bytes(72) == 86016
    assert flash_batched.fma_bwd_smem_bytes(256, 72) == 236544


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


def _two_pass_forward(q, k, v, scale, tile=64, online_output=False):
    """The bf16 tensor-core forward's arithmetic (csrc/attention_fwd_mma.cuh)
    in torch on the CPU, for q, k, v (B, L, hd) in bf16: pass 1 over tiles
    of ``tile`` keys keeps a running row max m and a sum l rescaled by
    exp(m_old - m_new), in fp32; pass 2 recomputes the logits and forms
    exp(s - m) / l, rounded to bf16 before the fp32 product with v. Returns
    o (B, L, hd) in bf16 and lse = m + log l (B, 1, L) in fp32.
    ``online_output``: the usual online-softmax output instead of pass 2,
    o = sum of bf16-rounded exp(s - m_running) v, rescaled as m grows and
    divided by l at the end."""
    b, l, _ = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    tiles = [slice(t, t + tile) for t in range(0, l, tile)]

    def logits(keys):
        return torch.matmul(qf, kf[:, keys].transpose(-1, -2)) * scale

    m = torch.full((b, l, 1), float("-inf"))
    lsum = torch.zeros(b, l, 1)
    o = torch.zeros_like(qf)
    for keys in tiles:
        s = logits(keys)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        if online_output:
            o = o * alpha + torch.matmul(p.to(q.dtype).float(), vf[:, keys])
        m = m_new
    if online_output:
        o = o / lsum
    else:
        for keys in tiles:
            pb = (torch.exp(logits(keys) - m) / lsum).to(q.dtype).float()
            o = o + torch.matmul(pb, vf[:, keys])
    return o.to(q.dtype), (m + torch.log(lsum)).reshape(b, 1, l)


@pytest.mark.parametrize("hd", [72, 32])
def test_two_pass_forward_rounds_where_the_plain_versions_do(hd):
    """The premise of the tensor-core forward (#3 and #5 in bf16): its two
    passes over 64-key tiles, with a rescaled running sum, differ from the
    plain versions (packed_attention_big_reference, flash_fwd_reference) in
    under 0.5% of the bf16 outputs, and its lse by at most 1e-6 of max|lse|;
    the usual online-softmax output, which rounds unnormalised
    probabilities, differs in over 20%."""
    n, l, h = 1, 1024, 2
    qkv, _ = _inputs(n, l, h, hd, seed=12 + hd)
    x = torch.from_numpy(qkv).bfloat16()
    scale = hd ** -0.5
    q, k, v = (t.reshape(n * h, l, hd) for t in x.reshape(n, l, 3, h, hd).permute(2, 0, 3, 1, 4))

    def packed(o):
        return o.reshape(n, h, l, hd).permute(0, 2, 1, 3).reshape(n, l, h * hd)

    ref_packed = flash_big.packed_attention_big_reference(x, h, scale)
    ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
    o, lse = _two_pass_forward(q, k, v, scale)
    assert o.dtype == torch.bfloat16 and lse.shape == ref_lse.shape
    assert _share(packed(o), ref_packed) < 0.005
    assert _share(o, ref_o) < 0.005
    assert (lse - ref_lse).abs().max().item() <= 1e-6 * ref_lse.abs().max().item()
    online, _ = _two_pass_forward(q, k, v, scale, online_output=True)
    assert _share(packed(online), ref_packed) > 0.2
    assert _share(online, ref_o) > 0.2


def _whole_row_forward(qkv, h, scale, tile=64, fault=None):
    """The bf16 whole-row tensor-core forward's arithmetic
    (csrc/packed_attention_fwd.cu, kernel #1) in torch on the CPU, for qkv
    (N, L, 3D) in bf16: s once over the whole row in fp32, the exact row max
    m, e = exp(s - m), l summed by 64-key tiles, p = e / l (div_rn is the
    correctly rounded division) rounded to bf16, o = p v accumulated over
    the tiles in fp32. ``fault='unnormalised'``: e rounded to bf16 before
    the division, o = (bf16(e) v) / l."""
    n, l, three_d = qkv.shape
    q, k, v = flash_big._heads(qkv, h)
    tiles = [slice(t, t + tile) for t in range(0, l, tile)]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    lsum = sum(e[..., keys].sum(-1, keepdim=True) for keys in tiles)
    o = torch.zeros_like(q)
    for keys in tiles:
        if fault == "unnormalised":
            o = o + torch.matmul(e[..., keys].to(qkv.dtype).float(), v[:, :, keys]) / lsum
        else:
            o = o + torch.matmul((e[..., keys] / lsum).to(qkv.dtype).float(), v[:, :, keys])
    return o.permute(0, 2, 1, 3).reshape(n, l, three_d // 3).to(qkv.dtype)


@pytest.mark.parametrize("shape", [(2, 128, 4, 72), (2, 256, 4, 32), (3, 77, 4, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_whole_row_forward_rounds_where_the_plain_versions_do(interpret_mode, shape):
    """The premise of the bf16 whole-row tensor-core forward (#1): s formed
    once, the exact max, l summed by tiles and p / l rounded once agree with
    the plain version (``packed_attention_reference``) and with the bf16
    Pallas ``_packed_fwd`` in interpret mode within chip_smoke.py's bounds
    (FWD_REL_BOUND of max|ref|, BF16_MISMATCH_BOUND of the elements
    differing); here summation order only, under 0.5%. Rounding the
    unnormalised e instead differs in over 20%."""
    bf16 = torch.bfloat16
    rel, bound = chip_smoke.FWD_REL_BOUND[bf16], chip_smoke.BF16_MISMATCH_BOUND
    n, l, h, hd = shape
    qkv, _ = _inputs(n, l, h, hd, seed=15 + l + hd)
    x = torch.from_numpy(qkv).to(bf16)
    scale = hd ** -0.5
    got = _whole_row_forward(x, h, scale)
    assert got.dtype == bf16 and got.shape == (n, l, h * hd)
    theirs, _ = jax_fb._packed_fwd(jnp.asarray(qkv).astype(jnp.bfloat16), h, scale)
    refs = (flash_batched.packed_attention_reference(x, h, scale).float(),
            torch.from_numpy(np.array(theirs.astype(jnp.float32))))
    for ref in refs:
        diff = (got.float() - ref).abs()
        assert diff.max().item() <= rel * ref.abs().max().item()
        assert _share(got, ref) < min(0.005, bound)
    assert _share(_whole_row_forward(x, h, scale, fault="unnormalised"), refs[0]) > 0.2


def test_whole_row_forward_shared_memory():
    """The bf16 whole-row tensor-core forward's shared memory
    (csrc/packed_attention_fwd.cu ``mma_fwd::smem_bytes``): the K and V
    rings, four bf16 [64][hd16 + 8] tiles, and the block's logits, fp32
    [64][L] with L padded to 64. Two blocks fit an SM at the main path's
    shapes; it takes every bf16 shape the route sends the whole-row kernel
    at a head dim that is a multiple of 8 but hd 8 at L 833-1184 and hd 16
    at L 833-864 (within the route's old window, ``route_window``), which
    keep the FMA kernel (and its layout) as other head dims do. fp32 takes
    the tensor-core forward (``mma6``) at every L."""
    assert flash_batched.mma_fwd_smem_bytes(128, 72) == 77824
    assert flash_batched.mma_fwd_smem_bytes(256, 72) == 110592
    assert flash_batched.mma_fwd_smem_bytes(256, 32) == 86016
    assert flash_batched.mma_fwd_smem_bytes(77, 40) == flash_batched.mma_fwd_smem_bytes(128, 40)
    for l, hd in ((128, 72), (256, 72), (256, 32)):
        assert 2 * (flash_batched.mma_fwd_smem_bytes(l, hd) + 1024) <= 233472
    bf16 = torch.bfloat16
    for hd in range(8, 129, 8):
        hd16 = -(-hd // 16) * 16
        for l in range(1, 1300, 7):
            want = 4 * 64 * (hd16 + 8) * 2 + 64 * (-(-l // 64) * 64) * 4
            assert flash_batched.mma_fwd_smem_bytes(l, hd) == want
            if not flash_batched.route_window(l, hd, False):
                continue
            kernel = flash_batched.fwd_kernel(bf16, l, hd)
            corner = 832 < l <= {8: 1184, 16: 864}.get(hd, 0)
            assert kernel == ("fma" if corner else "mma"), (l, hd)
            lp = -(-l // 32) * 32  # the FMA kernel's: K, V bf16, q, logits fp32
            fma = 128 * hd + 2 * hd * lp * 2 + 128 * lp + 2048
            assert flash_batched.fwd_smem_bytes(l, hd, 2) == (want if kernel == "mma" else fma)
            assert flash_batched.fwd_smem_bytes(l, hd, 2) <= flash_batched.SMEM_LIMIT
    assert flash_batched.fwd_kernel(torch.float32, 256, 72) == "mma6"
    assert flash_batched.fwd_kernel(bf16, 77, 20) == "fma"
    assert flash_batched.fwd_kernel(torch.float32, 77, 20) == "fma"
    # fp32: the tensor-core forward's layout; the FMA layout that
    # route_window reads grows with L
    assert flash_batched.fwd_smem_bytes(256, 72, 4) == 96256 == flash_batched.fwd_smem_bytes(64, 72, 4)
    assert flash_batched.fma_fwd_smem_bytes(256, 72, 4) == 191488


def _three_stage_bwd(qkv, dout, h, scale, tile=64, fault=None):
    """The bf16 tensor-core backward's arithmetic (csrc/attention_bwd_mma.cuh,
    kernels #2 and #4) in torch on the CPU, for qkv (N, L, 3D) and dout
    (N, L, D) in bf16; returns dqkv in bf16. Row pass: over tiles of
    ``tile`` keys a running row max m and a sum l rescaled by exp(m_old -
    m_new), in fp32; then p = exp(s - m) / l per tile, pb = p rounded to
    bf16, o += pb v in fp32, delta = sum(do * o) from the unrounded o. Query
    pass: per key tile, p rebuilt from m and l, dp = do v^T, ds = p (dp -
    delta) scale rounded to bf16, dq += ds k. Key pass: per tile of ``tile``
    queries, dv += pb^T do and dk += ds^T q, in fp32. ``fault``:
    'delta_from_rounded_o' rounds o to bf16 before delta; 'ds_from_pb' forms
    ds from pb instead of p."""
    n, l, three_d = qkv.shape
    hd = three_d // 3 // h
    dt = qkv.dtype
    q, k, v = flash_big._heads(qkv, h)
    do = dout.reshape(n, l, h, hd).permute(0, 2, 1, 3).float()
    tiles = [slice(t, t + tile) for t in range(0, l, tile)]
    every = slice(None)

    def logits(keys, rows=every):
        return q[:, :, rows] @ k[:, :, keys].transpose(-1, -2) * scale

    m = torch.full((n, h, l, 1), float("-inf"))
    lsum = torch.zeros(n, h, l, 1)
    for keys in tiles:
        s = logits(keys)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        lsum = lsum * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
        m = m_new

    def probs(keys, rows=every):
        return torch.exp(logits(keys, rows) - m[:, :, rows]) / lsum[:, :, rows]

    o = torch.zeros_like(q)
    for keys in tiles:
        o = o + probs(keys).to(dt).float() @ v[:, :, keys]
    if fault == "delta_from_rounded_o":
        o = o.to(dt).float()
    delta = (do * o).sum(-1, keepdim=True)

    def dscores(keys, rows=every):
        p = probs(keys, rows)
        if fault == "ds_from_pb":
            p = p.to(dt).float()
        dp = do[:, :, rows] @ v[:, :, keys].transpose(-1, -2)
        return (p * (dp - delta[:, :, rows]) * scale).to(dt).float()

    dq = torch.zeros_like(q)
    for keys in tiles:
        dq = dq + dscores(keys) @ k[:, :, keys]
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for rows in tiles:  # every key block sums over the query tiles in order
        dv = dv + probs(every, rows).to(dt).float().transpose(-1, -2) @ do[:, :, rows]
        dk = dk + dscores(every, rows).transpose(-1, -2) @ q[:, :, rows]
    dqkv = torch.stack([dq, dk, dv]).to(dt)  # (3, N, H, L, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, l, three_d)


def _bf16_pallas_bwd(fn, qkv, dout):
    """The JAX custom VJP ``fn`` (a Pallas kernel pair, in interpret mode)
    on bf16 inputs: dqkv as fp32 torch."""
    x = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(fn, x)
    (dx,) = vjp(jnp.asarray(dout.float().numpy()).astype(jnp.bfloat16))
    return torch.from_numpy(np.array(dx.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(1, 512, 2, 72), (1, 1024, 2, 32), (1, 777, 2, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_three_stage_backward_rounds_where_the_plain_versions_do(interpret_mode, shape):
    """The premise of the bf16 tensor-core backward (#2 and #4): its three
    stages over 64-row tiles, with p rebuilt from the saved m and l, delta
    from the fp32 o and ds from the fp32 p, differ from both plain versions
    (packed_attention_big_bwd_reference, packed_attention_bwd_reference) and,
    at the JAX window's L, from the Pallas ``_big_bwd`` in interpret mode in
    under 0.5% of the bf16 outputs (summation order: here 0.03-0.16%). A
    moved rounding point differs in over 10%: delta from the bf16-rounded o
    (12-15% here) or ds from pb instead of p (35-37%)."""
    n, l, h, hd = shape
    qkv, dout = _inputs(n, l, h, hd, seed=14 + l + hd)
    x, g = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(dout).bfloat16()
    scale = hd ** -0.5
    got = _three_stage_bwd(x, g, h, scale)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    ref = flash_big.packed_attention_big_bwd_reference(x, g, h, scale)
    assert _share(got, ref) < 0.005
    assert _share(got, flash_batched.packed_attention_bwd_reference(x, g, h, scale)) < 0.005
    if jax_big.supports(h, l, hd):
        theirs = _bf16_pallas_bwd(lambda a: jax_big.packed_attention_big(a, h, scale), x, g)
        assert _share(got, theirs) < 0.005
    for fault in ("delta_from_rounded_o", "ds_from_pb"):
        assert _share(_three_stage_bwd(x, g, h, scale, fault=fault), ref) > 0.1, fault


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest fp32 value, ties to even (normal range)."""
    if x == 0:
        return x
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += 1 if Fraction(2) ** (e + 1) <= x else (-1 if Fraction(2) ** e > x else 0)
    m = x * Fraction(2) ** (23 - e)
    whole, rest = divmod(m.numerator, m.denominator)
    if 2 * rest > m.denominator or (2 * rest == m.denominator and whole % 2):
        whole += 1
    return Fraction(whole) / Fraction(2) ** (23 - e)


def test_division_sequence_is_correctly_rounded():
    """csrc/attention_fwd_mma.cuh's div_rn forms p = e / l from r = 1 / l
    (rounded once per row): q = e r, then q + fma(-q, l, e) r, each step
    rounded once as fp32 multiplies and FMAs round. Over the kernel's
    operands (e = exp(s - m) in (0, 1], l a softmax sum in [1, 2048]) it is
    the correctly rounded e / l, the quotient torch's division gives, in
    exact arithmetic."""
    rng = np.random.default_rng(13)
    es = np.exp(-rng.uniform(0, 20, 3000)).astype(np.float32)
    ls = np.where(np.arange(3000) % 2, rng.uniform(1, 2048, 3000),
                  1 + rng.uniform(0, 1, 3000)).astype(np.float32)
    for e32, l32 in zip(es, ls):
        e, l = Fraction(float(e32)), Fraction(float(l32))
        r = _rn32(1 / l)
        q = _rn32(e * r)
        assert _rn32(q + _rn32(e - q * l) * r) == _rn32(e / l) == Fraction(float(e32 / l32))


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
    # order and, on the tensor cores, by the products' dropped bf16 terms
    # (~2^-24) and the mma.sync accumulation (at most 3.3e-6 measured on an
    # H100); bf16 by one rounding of p, ds or the output (one bf16 ulp is at
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
