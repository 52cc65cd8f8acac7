"""Kernel #7's new variants on the CPU: a bf16 gradient, the EMA-off mode
and a bf16 second moment with stochastic rounding.

The plain Philox4x32-10 is pinned to Random123's known answers; the plain
stochastic rounding is unbiased and leaves bf16 values exact (the port's
version of tests/test_fused_adam.py::test_stochastic_round_bf16_unbiased_
and_exact); a 20-step run with a bf16 nu tracks the fp32 run to the JAX
package's own bounds, as the JAX run does (its bits are threefry's, so
the comparison is statistical); the bf16-g and EMA-off updates match the
JAX fused update. The CUDA kernel is held to the plain version bit for bit
by the CUDA-only test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.ops import fused_adam as jax_fa
from maskdit_tpu_torch.ops import fused_adam

SHAPES = {"kernel": (64, 384), "bias": (384,), "tiny": (3, 5), "ragged": (130,)}
# fp32 on both sides, the same operation order per element
TOL = dict(rtol=2e-6, atol=1e-7)
M32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    # Random123's kat_vectors for philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    c = tuple(torch.tensor([x], dtype=torch.int64) for x in counter)
    got = tuple(int(w) for w in fused_adam.philox4x32_10(c, key))
    assert got == want, [hex(w) for w in got]


def test_sr_bits_follow_the_element_index():
    """Element i takes word i % 4 of Philox at counter i // 4 under the key
    (0x6E75, count); a slice's bits are the whole buffer's."""
    whole = fused_adam.sr_bits(0, 40, 9, "cpu")
    for q in (0, 3, 9):
        c = (torch.tensor([q]), torch.zeros(1, dtype=torch.int64),
             torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
        words = [int(w) for w in fused_adam.philox4x32_10(c, (0x6E75, 9))]
        assert whole[4 * q:4 * q + 4].tolist() == words
    assert fused_adam.sr_bits(13, 17, 9, "cpu").tolist() == whole[13:30].tolist()
    assert not torch.equal(fused_adam.sr_bits(0, 40, 10, "cpu"), whole)
    # the rounding in pieces is the rounding of the whole
    x = torch.rand(1000) + 1.0
    piece = fused_adam._SR_PIECE
    try:
        fused_adam._SR_PIECE = 96
        pieces = fused_adam.stochastic_round_bf16(x, 4)
    finally:
        fused_adam._SR_PIECE = piece
    assert torch.equal(pieces.view(torch.int16),
                       fused_adam.stochastic_round_bf16(x, 4).view(torch.int16))


def test_stochastic_round_bf16_unbiased_and_exact():
    """bf16 values pass through bit for bit; a value between two bf16
    neighbours rounds up with the probability of its fractional position,
    so the mean comes back (the JAX test's bounds)."""
    exact = torch.tensor([1.0, -2.0, 0.0, 0.00390625]).repeat(64)
    out = fused_adam.stochastic_round_bf16(exact, 0)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), exact)
    lo, gap = 1.0, 2.0 ** -7  # the bf16 ulp at 1.0
    for count, f in enumerate((0.25, 0.5, 0.75)):
        x = torch.full((1 << 16,), lo + f * gap)
        got = fused_adam.stochastic_round_bf16(x, count).float()
        # std of the mean ~ gap * sqrt(f(1-f)/n) ~ gap * 0.002
        assert abs(float(got.double().mean()) - (lo + f * gap)) < 0.02 * gap, f
        assert set(got.unique().tolist()) <= {lo, lo + gap}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    return {name: dict(g=mk(s), p=mk(s), m=mk(s) * 0.1, v=np.abs(mk(s)) * 0.01, e=mk(s))
            for name, s in SHAPES.items()}


def _flat(leaves, key):
    return torch.from_numpy(np.concatenate([leaves[n][key].reshape(-1) for n in SHAPES]))


def _unflat(flat):
    out, off = {}, 0
    for name, shape in SHAPES.items():
        n = int(np.prod(shape))
        out[name] = flat[off:off + n].reshape(shape)
        off += n
    return out


@pytest.mark.parametrize("g_bf16,with_ema", [(True, True), (False, False), (True, False)])
def test_bf16_grad_and_ema_off_match_jax(g_bf16, with_ema):
    """A bf16 g is upcast at the boundary (fused_adam.py:101); the EMA-off
    update is JAX's with decay 1.0 (state.py:200-211): the EMA unchanged."""
    leaves = _leaves(5)
    tree = lambda k: {n: jnp.asarray(v[k]) for n, v in leaves.items()}
    g = {n: a.astype(jnp.bfloat16) for n, a in tree("g").items()} if g_bf16 else tree("g")
    lr, count = 3e-3, 4
    new_p, new_m, new_v, new_e = jax_fa.fused_adam_ema(
        g, tree("p"), tree("m"), tree("v"), tree("e"), lr=jnp.asarray(lr),
        count_inc=jnp.asarray(count), ema_decay=0.99 if with_ema else 1.0, mode="interpret",
    )
    tg = _flat(leaves, "g").to(torch.bfloat16 if g_bf16 else torch.float32)
    p, m, v, e = (_flat(leaves, k).clone() for k in "pmve")
    e0 = e.clone()
    fused_adam.fused_adam_ema(tg, p, m, v, e, lr=lr, count_inc=count, ema_decay=0.99,
                              with_ema=with_ema)
    for got, want in ((p, new_p), (m, new_m), (v, new_v), (e, new_e)):
        for name, arr in _unflat(got).items():
            np.testing.assert_allclose(arr.numpy(), np.asarray(want[name]), **TOL, err_msg=name)
    if not with_ema:
        assert torch.equal(e, e0)


def test_bf16_nu_one_update_matches_jax_within_its_rounding():
    """p, m and the EMA read nu's fp32 value before it is stored, so they
    match JAX's; the stored bf16 nu is one of the two bf16 neighbours of
    JAX's fp32 value, as JAX's own stochastically rounded nu is."""
    leaves = _leaves(6)
    tree = lambda k: {n: jnp.asarray(v[k]) for n, v in leaves.items()}
    v_bf16 = {n: a.astype(jnp.bfloat16) for n, a in tree("v").items()}
    new_p, new_m, new_v32, new_e = jax_fa.fused_adam_ema(
        tree("g"), tree("p"), tree("m"), {n: a.astype(jnp.float32) for n, a in v_bf16.items()},
        tree("e"), lr=jnp.asarray(1e-3), count_inc=jnp.asarray(3), ema_decay=0.99, mode="jnp",
    )
    p, m, e = (_flat(leaves, k).clone() for k in "pme")
    v = _flat(leaves, "v").to(torch.bfloat16)
    fused_adam.fused_adam_ema(_flat(leaves, "g"), p, m, v, e, lr=1e-3, count_inc=3,
                              ema_decay=0.99)
    assert v.dtype == torch.bfloat16
    for got, want in ((p, new_p), (m, new_m), (e, new_e)):
        for name, arr in _unflat(got).items():
            np.testing.assert_allclose(arr.numpy(), np.asarray(want[name]), **TOL, err_msg=name)
    for name, arr in _unflat(v).items():
        ref = torch.from_numpy(np.asarray(new_v32[name]))
        down = ref.to(torch.bfloat16)  # nearest; the other neighbour is one ulp away
        ulp = (down.float().abs() * 2.0 ** -7).clamp_min(1e-30)
        assert ((arr.float() - ref).abs() <= ulp * 1.01).all(), name


def test_bf16_nu_tracks_fp32_as_jax_does():
    """Over 20 steps the bf16-nu run stays within the JAX test's bounds of
    the fp32 run (tests/test_fused_adam.py:209-262: nu median relative
    difference < 0.02, max < 0.15; params median < 0.05 lr, max < lr), in
    the port and in the JAX package alike; the rounding is a function of
    (state, gradient, count), so the same update twice is the same."""
    lr = 1e-3
    rng = np.random.default_rng(0)
    params0 = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: np.random.default_rng(300 + k).normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()} for k in range(20)]
    flat = lambda tree: torch.from_numpy(np.concatenate([tree[n].reshape(-1) for n in SHAPES]))

    ports = {}
    for nu in (None, torch.bfloat16):
        opt = fused_adam.FusedAdamEma(lr, nu_dtype=nu)
        p = flat(params0).clone()
        e, state = p.clone(), opt.init(p)
        assert state.nu.dtype == (nu or torch.float32) and state.mu.dtype == torch.float32
        for g in grads:
            opt.update_with_ema(flat(g), state, p, e, ema_decay=0.995)
        ports[nu] = (p, state.nu.float())
        assert e.dtype == torch.float32
    jaxes = {}
    for nu in (None, jnp.bfloat16):
        opt = jax_fa.FusedAdamEma(lr, nu_dtype=nu)
        p = {n: jnp.asarray(a) for n, a in params0.items()}
        e, state = p, opt.init(p)
        for g in grads:
            p, state, e = opt.update_with_ema({n: jnp.asarray(a) for n, a in g.items()},
                                              state, p, e, ema_decay=0.995)
        jaxes[nu] = (flat({n: np.asarray(a) for n, a in p.items()}),
                     flat({n: np.asarray(a, np.float32) for n, a in state[0].nu.items()}))

    for (p32, nu32), (p16, nu16) in ((ports[None], ports[torch.bfloat16]),
                                     (jaxes[None], jaxes[jnp.bfloat16])):
        a, b = nu32.double(), nu16.double()
        rel = (a - b).abs() / a.abs().clamp_min(1e-12)
        assert rel.median() < 0.02 and rel.max() < 0.15, (rel.median(), rel.max())
        dev = (p32 - p16).abs()
        assert dev.median() < 0.05 * lr and dev.max() < 1.0 * lr, (dev.median(), dev.max())
    # the fp32 runs agree with each other to fp32 rounding
    np.testing.assert_allclose(ports[None][0].numpy(), jaxes[None][0].numpy(), rtol=1e-5,
                               atol=1e-6)

    # determinism: the same update twice
    opt = fused_adam.FusedAdamEma(lr, nu_dtype=torch.bfloat16)
    outs = []
    for _ in range(2):
        p = flat(params0).clone()
        state = opt.init(p)
        opt.update_with_ema(flat(grads[0]), state, p, p.clone())
        outs.append(state.nu.view(torch.int16).clone())
    assert torch.equal(*outs)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dt,m_dt,v_dt,with_ema", [
    (torch.bfloat16, torch.float32, torch.float32, True),
    (torch.float32, torch.float32, torch.bfloat16, True),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.float32, torch.float32, False),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
])
@pytest.mark.parametrize("numel", [1 << 20, 1000003])
def test_cuda_kernel_new_variants_equal_plain_bit_for_bit(numel, g_dt, m_dt, v_dt, with_ema):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    gen = torch.Generator("cuda").manual_seed(0)
    rnd = lambda: torch.randn(numel, device="cuda", generator=gen)
    g, p, e = rnd().to(g_dt), rnd(), rnd()
    m, v = (rnd() * 0.1).to(m_dt), (rnd().abs() * 0.01).to(v_dt)
    scalars = fused_adam.adam_scalars(1e-3, 7, 0.9, 0.999, 1e-8, 0.9999)
    want = fused_adam.fused_adam_ema_reference(g, p, m, v, e, **scalars, sr_count=6,
                                               with_ema=with_ema)
    fused_adam.fused_adam_ema(g, p, m, v, e, lr=1e-3, count_inc=7, with_ema=with_ema)
    torch.cuda.synchronize()
    for got, ref in zip((p, m, v, e), want):
        assert torch.equal(got, ref)


def test_bf16_nu_crosses_from_flax_and_through_a_checkpoint(tiny_dit_module):
    """A JAX bf16 nu (``FusedAdamEma(nu_dtype=bfloat16)`` after one update)
    loads exactly through ``optimizer_state_from_flax`` into the port's bf16
    nu, and ``checkpoint()`` -> ``load()`` keeps its bits."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer
    from maskdit_tpu_torch.utils.port import optimizer_state_from_flax
    from tests.test_torch_masked_model import make_pair
    from tests.test_torch_model import patch_tiny_port

    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    try:
        _, params, model = make_pair(True, 0.1, seed=22)
    finally:
        mp.undo()
    rng = np.random.default_rng(23)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), params)
    jax_opt = jax_fa.FusedAdamEma(1e-3, nu_dtype=jnp.bfloat16)
    _, jax_state, _ = jax_opt.update_with_ema(grads, jax_opt.init(params), params, params)
    opt = optimizer_state_from_flax(jax_state[0])
    ours = create_train_state(model, make_optimizer(1e-3, 4, nu_dtype="bfloat16"))
    ours.load_opt_state(opt)
    assert ours.opt_state.nu.dtype == torch.bfloat16 and ours.opt_state.count == 1
    for k, v in ours.named(ours.opt_state.nu).items():
        assert torch.equal(v.float(), opt["nu"][k]), k
    ckpt = ours.checkpoint()
    assert all(v.dtype == torch.bfloat16 for v in ckpt["opt"]["nu"].values())
    other = create_train_state(model, make_optimizer(1e-3, 4, nu_dtype="bfloat16"))
    other.load(ckpt)
    assert torch.equal(other.opt_state.nu.view(torch.int16), ours.opt_state.nu.view(torch.int16))
