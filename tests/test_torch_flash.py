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

import chip_smoke
from maskdit_tpu.ops import flash as jax_flash
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big

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
    computes it: in both types tensor-core kernels whose shared memory does
    not depend on L, so every L of the window launches at every head dim
    the wrapper takes. fp32: the kernels of csrc/attention_fp32_mma.cuh
    (the forward's Q tile and K and V rings; the backward's larger kernel),
    no longer 32 or 16 rows of fp32 logits per block; bf16: the tensor-core
    forward (csrc/attention_fwd_mma.cuh), 64 query rows per block."""
    assert flash.fwd_smem_bytes(72) == 96256 and flash.fwd_smem_bytes(32) == 47104
    assert flash.bwd_smem_bytes(72) == 114688 and flash.bwd_smem_bytes(32) == 94208
    assert flash.fwd_smem_bytes(72, 2) == 45056
    assert flash.fwd_smem_bytes(32, 2) == 20480
    assert flash.fwd_smem_bytes(40, 2) == 28672
    for hd in range(8, 129, 8):
        for esize in (2, 4):
            assert flash.fwd_smem_bytes(hd, esize) <= flash_batched.SMEM_LIMIT, (hd, esize)
            assert flash.bwd_smem_bytes(hd, esize) <= flash_batched.SMEM_LIMIT, (hd, esize)
        assert flash.fwd_smem_bytes(hd, 2) <= 69632


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_fp32_kernels_are_the_tensor_core_ones(hd):
    """fp32 at every head dim the wrapper takes runs the tensor-core kernels
    ('mma6') that the packed wrappers run in fp32, in the separate-heads
    layout: the same tiles, so the same shared memory, at every L of the
    window; within a block's limit, and two blocks share an SM at the model
    head dims."""
    fp32 = torch.float32
    assert flash.fwd_kernel(fp32) == flash.bwd_kernel(fp32) == "mma6"
    assert flash.fwd_kernel(torch.bfloat16) == flash.bwd_kernel(torch.bfloat16) == "mma"
    fwd, bwd = flash.fwd_smem_bytes(hd), flash.bwd_smem_bytes(hd)
    assert fwd == flash.fwd_smem_bytes(hd, 4) == flash_batched.fp32_fwd_smem_bytes(hd)
    assert bwd == flash.bwd_smem_bytes(hd, 4) == flash_batched.fp32_bwd_smem_bytes(hd)
    for l in range(flash.LANE, flash.MAX_L + 1, flash.LANE):
        assert fwd == flash_big.fwd_smem_bytes(l, hd, 4) == flash_batched.fwd_smem_bytes(l, hd, 4)
        assert bwd == flash_big.bwd_smem_bytes(l, hd, 4) == flash_batched.bwd_smem_bytes(l, hd, 4)
    assert max(fwd, bwd) <= flash_batched.SMEM_LIMIT
    if hd in (32, 64, 72):
        assert 2 * (max(fwd, bwd) + 1024) <= 233472


@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_bf16_backward_shared_memory(hd):
    """What csrc/flash_bwd.cu's bf16 tensor-core kernels lay out, as the
    module computes it: the key kernel's six bf16 [64][hd16 + 8] tiles (its
    K and V, the Q and dO rings; hd16 = hd padded to 16) and its fp32 p^T
    and ds^T tiles, [64][72] each; the query kernel's four tiles are fewer.
    The same at every L, within a block's limit; two blocks fit an SM at
    the model head dims. fp32 takes attention_fp32_mma.cuh's layout."""
    hd16 = -(-hd // 16) * 16
    want = 6 * 64 * (hd16 + 8) * 2 + 2 * 64 * 72 * 4
    assert flash.bwd_smem_bytes(hd, 2) == want > 4 * 64 * (hd16 + 8) * 2
    assert want <= flash_batched.SMEM_LIMIT
    if hd in (32, 64, 72):
        assert 2 * (want + 1024) <= 233472
    assert flash.bwd_smem_bytes(hd) == flash_batched.fp32_bwd_smem_bytes(hd)
    assert flash.bwd_kernel(torch.bfloat16) == "mma" and flash.bwd_kernel(torch.float32) == "mma6"
    assert flash.bwd_smem_bytes(72, 2) == 104448 and flash.bwd_smem_bytes(32, 2) == 67584


def _split(x: torch.Tensor, pieces: int = 3) -> list:
    """The bf16 tensor-core backward's split (csrc/flash_bwd.cu ``split3``)
    of fp32 values into bf16 pieces: x0 = bf16(x), then each next piece the
    bf16 of what the earlier ones leave, subtracted in fp32."""
    out, rest = [], x
    for _ in range(pieces):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


def _spread(n: int, seed: int, signed: bool) -> torch.Tensor:
    """fp32 values with random significands from 1 down to 1e-30, as p
    (positive) and ds (both signs) take them."""
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(-30, 0, n)
    if signed:
        x *= rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("signed", [False, True], ids=["p", "ds"])
def test_three_bf16_pieces_are_exact(signed):
    """The premise of #6's bf16 products: every fp32 value of p's and ds's
    ranges is the sum of its three bf16 pieces, bit for bit; each fp32
    subtraction of the split is exact and the last piece needs no rounding.
    Two pieces (16 significand bits of fp32's 24) leave over 90% of the
    values short (here ~96%)."""
    x = _spread(20000, 31 + signed, signed)
    x0, x1, x2 = _split(x)
    exact = x0.double() + x1.double() + x2.double()
    assert torch.equal(exact, x.double())
    r1 = x.double() - x0.double()
    assert torch.equal((x - x0.float()).double(), r1)
    assert torch.equal((r1.float() - x1.float()).double(), r1 - x1.double())
    assert torch.equal(x2.float().double(), r1 - x1.double())
    two = x0.double() + x1.double()
    assert (two == x.double()).double().mean().item() < 0.1


def _split_bwd(q, k, v, o, lse, do, scale, pieces=3, tile=64):
    """The bf16 tensor-core flash backward's arithmetic (csrc/flash_bwd.cu)
    in torch on the CPU, for (B, L, hd) bf16 residuals: delta = sum(do * o)
    from the stored o; per tile p = exp(s - lse) and ds = (p (dp - delta))
    scale in fp32, each split into ``pieces`` bf16 pieces (``_split``) whose
    products with the bf16 operand run in fp32; the query kernel adds
    ds K over key tiles, the key kernel p^T dO and ds^T Q over query tiles,
    piece by piece. Returns dq, dk, dv in bf16."""
    b, l, _ = q.shape
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    lse = lse.reshape(b, l, 1)
    delta = (gf * of).sum(-1, keepdim=True)
    tiles = [slice(t, t + tile) for t in range(0, l, tile)]
    every = slice(None)

    def p_ds(rows, keys):
        s = torch.matmul(qf[:, rows], kf[:, keys].transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, rows])
        dp = torch.matmul(gf[:, rows], vf[:, keys].transpose(-1, -2))
        return p, p * (dp - delta[:, rows]) * scale

    def add(acc, x, y):
        for piece in _split(x, pieces):
            acc = acc + torch.matmul(piece.float(), y)
        return acc

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for keys in tiles:
        dq[:, :] = add(dq, p_ds(every, keys)[1], kf[:, keys])
    for rows in tiles:
        p, ds = p_ds(rows, every)
        dv = add(dv, p.transpose(-1, -2), gf[:, rows])
        dk = add(dk, ds.transpose(-1, -2), qf[:, rows])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("shape", [(4, 256, 72), (4, 128, 32), (3, 384, 40)],
                         ids=lambda s: "x".join(map(str, s)))
def test_split_backward_rounds_where_the_plain_versions_do(interpret_mode, shape):
    """The premise of the bf16 tensor-core flash backward (#6): its products
    on three exact bf16 pieces of p and ds agree with the plain version
    (``flash_bwd_reference``) and with the bf16 Pallas ``_flash_bwd`` in
    interpret mode within chip_smoke.py's bounds (BWD_REL_BOUND of max|ref|,
    BF16_MISMATCH_BOUND of the elements differing); here summation order
    only, under 0.1% (0.01-0.05%, as the plain version against the Pallas
    kernel). Two pieces differ in several times more (0.19-0.32% here),
    and one piece, p and ds rounded to bf16 as the packed backwards round
    them, in more elements than the bound allows (~42%)."""
    bf16 = torch.bfloat16
    rel, bound = chip_smoke.BWD_REL_BOUND[bf16], chip_smoke.BF16_MISMATCH_BOUND
    (q, k, v, g), (tq, tk, tv, tg) = _both(_inputs(shape, sum(shape) + 5), "bfloat16")
    scale = shape[-1] ** -0.5
    _, residuals = jax_flash._flash_fwd(q, k, v, scale)
    theirs = jax_flash._flash_bwd(scale, residuals, g)
    o = torch.from_numpy(np.array(residuals[3].astype(jnp.float32))).to(bf16)
    lse = torch.from_numpy(np.array(residuals[4]))
    plain = flash.flash_bwd_reference(tq, tk, tv, o, lse, tg, scale)
    got = _split_bwd(tq, tk, tv, o, lse, tg, scale)

    def shares(pieces):
        grads = _split_bwd(tq, tk, tv, o, lse, tg, scale, pieces=pieces)
        return [((a.float() - b.float()).abs() > 0).float().mean().item()
                for a, b in zip(grads, plain)]

    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, theirs):
        assert a.dtype == bf16
        for ref in (b.float(), torch.from_numpy(np.array(c.astype(jnp.float32)))):
            diff = (a.float() - ref).abs()
            assert diff.max().item() <= rel * ref.abs().max().item(), name
            assert (diff > 0).float().mean().item() < min(0.001, bound), name
    assert max(shares(2)) > 0.0015
    assert max(shares(1)) > bound


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
