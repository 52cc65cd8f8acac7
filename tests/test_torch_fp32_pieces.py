"""The arithmetic of the fp32 attention on the tensor cores
(csrc/attention_fp32_mma.cuh: the blocked kernels #3 and #4, the whole-row
kernels #1 and #2 and the flash kernels #5 and #6 for fp32), emulated in
torch on the CPU and held to the plain versions and to the JAX Pallas
kernels.

The kernels split each fp32 operand of a product exactly into three bf16
pieces and run the product as the six bf16 products a_i . b_j with
i + j <= 2, each exact in fp32 and summed in fp32 (all nine terms are
emulated beside them: the same error, summation order aside). Here ``_product`` does the same with torch matmuls on fp32 tensors
that hold bf16 values (each product exact, the sums fp32, in another order
than the tensor cores'). The forward is one online-softmax pass over tiles
of 64 keys; the backward's query kernel repeats that pass for m, l and o,
then forms dq over key tiles, and its key kernel forms dk and dv over query
tiles, p rebuilt from m and l. The flash
pair runs the same products in its separate-heads layout: the forward's
pass also gives lse = m + log l; the backward takes p = exp(s - lse) and
delta = sum(do * o) from the stored o, so its query kernel runs no forward
pass.

The emulations run many small fp32 matmuls; under ``pytest -n`` several
workers each taking every core's worth of torch threads slowed this file's
blocked cases several-fold, so its tests run on EMULATION_THREADS intra-op
threads (the ``few_threads`` fixture). One: on two, in some fresh
processes under load, the first ``torch.exp`` that ran on the second
OpenMP thread came out up to 1e-4 off (one (head, query chunk) block of
the plain version's probabilities, and of the emulation's; the Pallas
reference was right), which put the (1, 512, 2, 72) case 1.8e-5 from the
Pallas forward, past FWD_ATOL. On one thread no run showed it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import flash as jax_flash
from maskdit_tpu.ops import flash_batched as jax_fb
from maskdit_tpu.ops import flash_big as jax_big
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big
from tests.test_torch_flash import _split
from tests.test_torch_flash_big import BWD_ATOL, FWD_ATOL

TILE = 64
SHAPES = [(1, 512, 2, 72), (1, 1024, 2, 32), (1, 777, 2, 40)]
# the whole-row kernels' cases: L 128 at XL/2's encoder and decoder head dims
WHOLE_ROW_SHAPES = [(1, 128, 2, 72), (1, 128, 2, 32)]
# the fp32 kernels against their plain versions and the Pallas kernels, as
# chip_smoke.py holds them on the card: max error <= 1e-5 of max|ref|
REL_BOUND = 1e-5
# the flash kernels' cases, (N*H, L, hd): XL/2's encoder and decoder head
# dims, and hd 40 (one m16n8k8 step) at an L of three 128-key blocks
FLASH_SHAPES = [(2, 128, 72), (2, 256, 32), (1, 384, 40)]
EMULATION_THREADS = 1


@pytest.fixture(autouse=True)
def few_threads():
    """EMULATION_THREADS torch intra-op threads for each test, whatever the
    process had, restored after it."""
    was = torch.get_num_threads()
    torch.set_num_threads(EMULATION_THREADS)
    yield
    torch.set_num_threads(was)


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _pieces(x: torch.Tensor, count: int = 3) -> list:
    """csrc ``split3``'s pieces (``_split``) as fp32 tensors holding bf16
    values."""
    return [piece.float() for piece in _split(x, count)]


def _product(a: torch.Tensor, b: torch.Tensor, pieces: int = 3, terms: int = 6):
    """a @ b as the kernels form it: the products of the bf16 pieces a_i . b_j
    with i + j <= ``pieces`` - 1 (three pieces: six terms), or all of them
    (``terms`` 9), the smaller terms first."""
    pa, pb = _pieces(a, pieces), _pieces(b, pieces)
    top = 2 * (pieces - 1) if terms == 9 else pieces - 1
    acc = None
    for order in range(top, -1, -1):
        for i in range(pieces - 1, -1, -1):
            j = order - i
            if 0 <= j < pieces:
                term = pa[i] @ pb[j]
                acc = term if acc is None else acc + term
    return acc


def _attend(q, k, v, scale, mm):
    """The forward's pass over key tiles: o / l, m and l."""
    n, h, l, _ = q.shape
    m = torch.full((n, h, l, 1), float("-inf"))
    lsum = torch.zeros(n, h, l, 1)
    o = torch.zeros_like(q)
    for k0 in range(0, l, TILE):
        keys = slice(k0, k0 + TILE)
        s = mm(q, k[:, :, keys].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        lsum = lsum * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + mm(e, v[:, :, keys])
        m = m_new
    return o / lsum, m, lsum


def _emulated_forward(qkv, h, scale, **scheme):
    n, l, three_d = qkv.shape
    q, k, v = flash_big._heads(qkv, h)
    o, _, _ = _attend(q, k, v, scale, lambda a, b: _product(a, b, **scheme))
    return o.permute(0, 2, 1, 3).reshape(n, l, three_d // 3)


def _emulated_backward(qkv, dout, h, scale, **scheme):
    n, l, three_d = qkv.shape
    hd = three_d // 3 // h
    mm = lambda a, b: _product(a, b, **scheme)  # noqa: E731
    q, k, v = flash_big._heads(qkv, h)
    do = dout.reshape(n, l, h, hd).permute(0, 2, 1, 3)
    # query kernel: the forward's pass, delta, then dq over key tiles
    o, m, lsum = _attend(q, k, v, scale, mm)
    delta = (do * o).sum(-1, keepdim=True)
    every = slice(None)

    def p_ds(rows, keys):
        s = mm(q[:, :, rows], k[:, :, keys].transpose(-1, -2)) * scale
        p = torch.exp(s - m[:, :, rows]) / lsum[:, :, rows]
        dp = mm(do[:, :, rows], v[:, :, keys].transpose(-1, -2))
        return p, p * (dp - delta[:, :, rows]) * scale

    tiles = [slice(t, t + TILE) for t in range(0, l, TILE)]
    dq = torch.zeros_like(q)
    for keys in tiles:
        dq = dq + mm(p_ds(every, keys)[1], k[:, :, keys])
    # key kernel: dk and dv over query tiles
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for rows in tiles:
        p, ds = p_ds(rows, every)
        dv = dv + mm(p.transpose(-1, -2), do[:, :, rows])
        dk = dk + mm(ds.transpose(-1, -2), q[:, :, rows])
    dqkv = torch.stack([dq, dk, dv])  # (3, N, H, L, hd)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(n, l, three_d)


def _spread(count: int, seed: int) -> torch.Tensor:
    """fp32 values of both signs with random significands from 1e-30 to 1e30,
    and normal draws."""
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(-30, 30, count) * rng.choice([-1.0, 1.0], count)
    return torch.from_numpy(np.concatenate([x, rng.normal(size=count)]).astype(np.float32))


def test_three_pieces_rebuild_every_fp32_value():
    """The premise: each fp32 value is the sum of its three bf16 pieces bit
    for bit, over tiny, huge and normal magnitudes (each subtraction of the
    split exact, the last piece needing no rounding); two pieces leave most
    values short."""
    x = _spread(20000, 41)
    x0, x1, x2 = _pieces(x)
    assert torch.equal(x0.double() + x1.double() + x2.double(), x.double())
    rest = x.double() - x0.double()
    assert torch.equal((x - x0).double(), rest)
    assert torch.equal(x2.double(), rest - x1.double())
    assert ((x0.double() + x1.double()) == x.double()).double().mean().item() < 0.1


def _errors(qkv, dout, h, scale, fwd_ref, bwd_ref, **scheme):
    fwd = (_emulated_forward(qkv, h, scale, **scheme) - fwd_ref).abs().max().item()
    bwd = (_emulated_backward(qkv, dout, h, scale, **scheme) - bwd_ref).abs().max().item()
    return fwd, bwd


def _pallas(qkv, dout, h, scale):
    """The JAX custom VJP on its Pallas kernels (interpret mode): out, dqkv."""
    out, vjp = jax.vjp(lambda a: jax_big.packed_attention_big(a, h, scale), qkv.numpy())
    (dx,) = vjp(dout.numpy())
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(dx))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_kernels_hold_the_fp32_bounds(interpret_mode, shape, capsys):
    """Six terms on three pieces (the kernels' scheme) are within FWD_ATOL /
    BWD_ATOL of the plain versions and, where the JAX window holds, of the
    Pallas ``_big_fwd`` / ``_big_bwd``; nine terms change the error by
    summation order only. The fault the bound catches: one piece (plain
    bf16 operands, as a one-pass TF32-like product would be short) misses
    it by far; two pieces are printed beside."""
    n, l, h, hd = shape
    rng = np.random.default_rng(17 + l + hd)
    qkv = torch.from_numpy(rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(n, l, h * hd)).astype(np.float32))
    scale = hd ** -0.5
    refs = [(flash_big.packed_attention_big_reference(qkv, h, scale),
             flash_big.packed_attention_big_bwd_reference(qkv, dout, h, scale))]
    if jax_big.supports(h, l, hd):
        refs.append(_pallas(qkv, dout, h, scale))
    for fwd_ref, bwd_ref in refs[::-1]:
        fwd, bwd = _errors(qkv, dout, h, scale, fwd_ref, bwd_ref)
        assert fwd <= FWD_ATOL and bwd <= BWD_ATOL, (fwd, bwd)
    fwd_ref, bwd_ref = refs[0]
    nine = _errors(qkv, dout, h, scale, fwd_ref, bwd_ref, terms=9)
    two = _errors(qkv, dout, h, scale, fwd_ref, bwd_ref, pieces=2)
    one = _errors(qkv, dout, h, scale, fwd_ref, bwd_ref, pieces=1)
    assert nine[0] <= FWD_ATOL and nine[1] <= BWD_ATOL, nine
    assert one[0] > 10 * FWD_ATOL and one[1] > 10 * BWD_ATOL, one
    with capsys.disabled():
        print(f"\n[fp32 pieces] {shape}: max abs error fwd / bwd against the plain "
              f"versions: 6 terms {fwd:.3e} / {bwd:.3e}, 9 terms {nine[0]:.3e} / "
              f"{nine[1]:.3e}, two pieces {two[0]:.3e} / {two[1]:.3e}, one piece "
              f"{one[0]:.3e} / {one[1]:.3e}")


def _whole_row_pallas(qkv, dout, h, scale):
    """The JAX custom VJP on its whole-row Pallas kernels ``_packed_fwd`` /
    ``_packed_bwd`` (interpret mode): out, dqkv."""
    out, vjp = jax.vjp(lambda a: jax_fb.packed_attention(a, h, scale), qkv.numpy())
    (dx,) = vjp(dout.numpy())
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(dx))


@pytest.mark.parametrize("shape", WHOLE_ROW_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_whole_row_kernels_hold_the_fp32_bounds(interpret_mode, shape):
    """In fp32 the whole-row wrapper (ops/flash_batched.py) launches the
    same tensor-core kernels as the blocked one ('mma6'); their six-term
    arithmetic is within 1e-5 of max|ref| of flash_batched's plain versions
    and of the JAX ``packed_attention`` on its Pallas ``_packed_fwd`` /
    ``_packed_bwd``. One piece per operand misses that bound by far."""
    n, l, h, hd = shape
    assert flash_batched.fwd_kernel(torch.float32, l, hd) == "mma6"
    assert flash_batched.bwd_kernel(torch.float32, hd) == "mma6"
    rng = np.random.default_rng(71 + hd)
    qkv = torch.from_numpy(rng.normal(size=(n, l, 3 * h * hd)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(n, l, h * hd)).astype(np.float32))
    scale = hd ** -0.5
    plain = (flash_batched.packed_attention_reference(qkv, h, scale),
             flash_batched.packed_attention_bwd_reference(qkv, dout, h, scale))
    got = (_emulated_forward(qkv, h, scale), _emulated_backward(qkv, dout, h, scale))
    one = (_emulated_forward(qkv, h, scale, pieces=1),
           _emulated_backward(qkv, dout, h, scale, pieces=1))
    for refs in (plain, _whole_row_pallas(qkv, dout, h, scale)):
        for ours, short, ref in zip(got, one, refs):
            bound = REL_BOUND * ref.abs().max().item()
            assert (ours - ref).abs().max().item() <= bound
            assert (short - ref).abs().max().item() > 10 * bound


@pytest.mark.parametrize("hd", range(4, 133, 4))
def test_fp32_whole_row_kernels_are_the_tensor_core_ones(hd):
    """fp32 at a head dim that is a multiple of 8, up to 128, runs the
    tensor-core kernels ('mma6') at every L, with the blocked kernels'
    shared memory (the same kernels); at other head dims the FMA kernels,
    whose layouts grow with L."""
    fp32 = torch.float32
    variant = "mma6" if hd % 8 == 0 and hd <= 128 else "fma"
    for l in (8, 77, 128, 224, 256, 512, 1024):
        assert flash_batched.fwd_kernel(fp32, l, hd) == variant, l
        if variant == "mma6":
            assert flash_batched.fwd_smem_bytes(l, hd, 4) == flash_big.fwd_smem_bytes(l, hd, 4)
            assert flash_batched.bwd_smem_bytes(l, hd, 4) == flash_big.bwd_smem_bytes(l, hd, 4)
        else:
            assert flash_batched.fwd_smem_bytes(l, hd, 4) == \
                flash_batched.fma_fwd_smem_bytes(l, hd, 4)
    if hd <= 128:
        assert flash_batched.bwd_kernel(fp32, hd) == variant
    if variant == "mma6":
        assert flash_batched.fwd_smem_bytes(128, hd, 4) <= flash_batched.SMEM_LIMIT
        assert flash_batched.bwd_smem_bytes(128, hd, 4) <= flash_batched.SMEM_LIMIT


def _emulated_flash_forward(q, k, v, scale, **scheme):
    """The fp32 flash forward (N*H, L, hd): the one online-softmax pass over
    key tiles, o / l, and lse = m + log l from the final running m and l."""
    o, m, lsum = _attend(q[None], k[None], v[None], scale,
                         lambda a, b: _product(a, b, **scheme))
    return o[0], (m + torch.log(lsum))[0].reshape(q.shape[0], 1, q.shape[1])


def _emulated_flash_backward(q, k, v, o, lse, do, scale, **scheme):
    """The fp32 flash backward: delta from the stored o; the query kernel's
    dq over key tiles and the key kernel's dk and dv over query tiles, each
    forming p = exp(s - lse) and ds alike."""
    mm = lambda a, b: _product(a, b, **scheme)  # noqa: E731
    n, l, _ = q.shape
    lse = lse.reshape(n, l, 1)
    delta = (do * o).sum(-1, keepdim=True)
    every = slice(None)

    def p_ds(rows, keys):
        s = mm(q[:, rows], k[:, keys].transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, rows])
        dp = mm(do[:, rows], v[:, keys].transpose(-1, -2))
        return p, p * (dp - delta[:, rows]) * scale

    tiles = [slice(t, t + TILE) for t in range(0, l, TILE)]
    dq = torch.zeros_like(q)
    for keys in tiles:
        dq = dq + mm(p_ds(every, keys)[1], k[:, keys])
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for rows in tiles:
        p, ds = p_ds(rows, every)
        dv = dv + mm(p.transpose(-1, -2), do[:, rows])
        dk = dk + mm(ds.transpose(-1, -2), q[:, rows])
    return dq, dk, dv


def _flash_case(shape):
    """q, k, v, do (N*H, L, hd) from a seed, and the scale."""
    rng = np.random.default_rng(101 + sum(shape))
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for _ in range(4))
    return q, k, v, do, shape[-1] ** -0.5


def _plain_flash(q, k, v, do, scale):
    """(o, lse, (dq, dk, dv)) of the plain versions, the backward on the
    forward's residuals."""
    o, lse = flash.flash_fwd_reference(q, k, v, scale)
    return o, lse, flash.flash_bwd_reference(q, k, v, o, lse, do, scale)


def _pallas_flash(q, k, v, do, scale):
    """The same from the JAX ``_flash_fwd`` / ``_flash_bwd`` on their Pallas
    kernels (interpret mode)."""
    jq, jk, jv, jg = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    o, residuals = jax_flash._flash_fwd(jq, jk, jv, scale)
    grads = jax_flash._flash_bwd(scale, residuals, jg)
    return (torch.from_numpy(np.array(o)), torch.from_numpy(np.array(residuals[4])),
            tuple(torch.from_numpy(np.array(g)) for g in grads))


def _flash_errors(q, k, v, do, scale, ref, **scheme):
    """The emulation's errors against one reference, each as a share of
    REL_BOUND x max|ref|: o, lse, dq, dk, dv. The backward runs on the
    reference's residuals, as the kernel runs on its forward's."""
    ref_o, ref_lse, ref_grads = ref
    o, lse = _emulated_flash_forward(q, k, v, scale, **scheme)
    grads = _emulated_flash_backward(q, k, v, ref_o, ref_lse, do, scale, **scheme)
    pairs = [(o, ref_o), (lse, ref_lse)] + list(zip(grads, ref_grads))
    return [(a - b).abs().max().item() / (REL_BOUND * b.abs().max().item()) for a, b in pairs]


@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_flash_kernels_hold_the_fp32_bounds(interpret_mode, shape):
    """In fp32 the flash wrapper (ops/flash.py, #5 / #6) launches the
    tensor-core kernels of csrc/attention_fp32_mma.cuh ('mma6'); their
    six-term arithmetic (the online forward with lse, the backward's p from
    lse and delta from the stored o) is within 1e-5 of max|ref| of the
    plain versions and of the JAX ``_flash_fwd`` / ``_flash_bwd`` on their
    Pallas kernels, for o, lse, dq, dk and dv. One piece per operand misses
    that bound by far."""
    assert flash.fwd_kernel(torch.float32) == flash.bwd_kernel(torch.float32) == "mma6"
    q, k, v, do, scale = _flash_case(shape)
    refs = [_plain_flash(q, k, v, do, scale), _pallas_flash(q, k, v, do, scale)]
    for ref in refs:
        errors = _flash_errors(q, k, v, do, scale, ref)
        assert max(errors) <= 1.0, errors
    short = _flash_errors(q, k, v, do, scale, refs[0], pieces=1)
    assert min(short[:1] + short[2:]) > 10, short


def test_two_pieces_miss_the_flash_bound():
    """The fault the bound catches in the flash pair: two bf16 pieces per
    operand (16 of 24 significand bits) carry the products' error past 1e-5
    of max|ref| in the backward's gradients (dq ~2x its bound here), where
    six terms on three pieces stay under a tenth of it."""
    q, k, v, do, scale = _flash_case(FLASH_SHAPES[0])
    plain = _plain_flash(q, k, v, do, scale)
    assert max(_flash_errors(q, k, v, do, scale, plain)) <= 1.0
    two = _flash_errors(q, k, v, do, scale, plain, pieces=2)
    assert max(two) > 1.0, two
