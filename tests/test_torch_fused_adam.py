"""The port's fused Adam + EMA update against the JAX package's.

The JAX side runs ``fused_adam_ema(..., mode='interpret')``: the Pallas
``_leaf_update_pallas`` kernel under the interpreter for 128-divisible
leaves, its jnp twin for the rest. The port's side is its plain version,
which the in-place wrapper takes for CPU tensors. The CUDA kernel is held
to that plain version by the CUDA-only test here and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskdit_tpu.ops import fused_adam as jax_fa
from maskdit_tpu.train.schedules import lr_with_rampup as jax_lr_with_rampup
from maskdit_tpu.utils.port import export_maskdit
from maskdit_tpu_torch.ops import fused_adam
from maskdit_tpu_torch.train.state import create_train_state, make_optimizer
from maskdit_tpu_torch.utils.port import optimizer_state_from_flax
from tests.test_torch_masked_model import make_pair
from tests.test_torch_model import patch_tiny_port

# fp32 on both sides, the same operation order per element; XLA:CPU may
# contract a product and a sum into one FMA where the port does not
TOL = dict(rtol=2e-6, atol=1e-7)
SHAPES = {"kernel": (64, 384), "bias": (384,), "tiny": (3, 5), "ragged": (130,)}


def _state(seed):
    rng = np.random.default_rng(seed)
    mk = lambda s: rng.normal(size=s).astype(np.float32)
    out = {}
    for name, shape in SHAPES.items():
        m = mk(shape) * 0.1
        out[name] = dict(g=mk(shape), p=mk(shape), m=m, v=np.abs(mk(shape)) * 0.01, e=mk(shape))
    return out


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [1, 7])
def test_plain_update_matches_pallas_interpret(count, mu_dtype):
    leaves = _state(count)
    lr, decay = 3e-3, 0.999
    jdt = getattr(jnp, mu_dtype)
    tree = lambda k: {n: jnp.asarray(v[k]) for n, v in leaves.items()}
    new_p, new_m, new_v, new_e = jax_fa.fused_adam_ema(
        tree("g"), tree("p"), jax.tree.map(lambda a: a.astype(jdt), tree("m")), tree("v"),
        tree("e"), lr=jnp.asarray(lr), count_inc=jnp.asarray(count), ema_decay=decay,
        mode="interpret",
    )
    tdt = getattr(torch, mu_dtype)
    for name, v in leaves.items():
        g, p, e, nu = (torch.from_numpy(v[k].copy()) for k in ("g", "p", "e", "v"))
        m = torch.from_numpy(v["m"].copy()).to(tdt)
        fused_adam.fused_adam_ema(g, p, m, nu, e, lr=lr, count_inc=count, ema_decay=decay)
        np.testing.assert_allclose(p.numpy(), np.asarray(new_p[name]), **TOL, err_msg=name)
        np.testing.assert_allclose(nu.numpy(), np.asarray(new_v[name]), **TOL, err_msg=name)
        np.testing.assert_allclose(e.numpy(), np.asarray(new_e[name]), **TOL, err_msg=name)
        assert m.dtype == tdt
        np.testing.assert_allclose(m.float().numpy(), np.asarray(new_m[name].astype(jnp.float32)),
                                   **TOL, err_msg=name)


def test_fused_adam_ema_is_in_place_and_counts_no_launch_on_cpu(monkeypatch):
    monkeypatch.setattr(fused_adam.fused_adam_ema, "launches", 0)
    v = _state(3)["kernel"]
    p = torch.from_numpy(v["p"].copy())
    ptr = p.data_ptr()
    fused_adam.fused_adam_ema(
        torch.from_numpy(v["g"]), p, torch.from_numpy(v["m"].copy()),
        torch.from_numpy(v["v"].copy()), torch.from_numpy(v["e"].copy()),
        lr=1e-3, count_inc=1,
    )
    assert p.data_ptr() == ptr and not np.array_equal(p.numpy(), v["p"])
    assert fused_adam.fused_adam_ema.launches == 0


def test_optimizer_with_rampup_matches_jax_class():
    """lr at the pre-increment count, bias correction at the post-increment
    one, over three steps of a warmup schedule (FusedAdamEma :380-395)."""
    base, gbs, kimg = 1e-3, 4, 0.01  # lr reaches base at step 2.5
    jax_opt = jax_fa.FusedAdamEma(lambda s: jax_lr_with_rampup(s, base, gbs, kimg))
    ours = make_optimizer(base, gbs, rampup_kimg=kimg)
    leaves = _state(11)
    params = {n: jnp.asarray(v["p"]) for n, v in leaves.items()}
    ema = params
    j_state = jax_opt.init(params)
    flat = lambda tree: torch.from_numpy(
        np.concatenate([np.asarray(tree[n]).reshape(-1) for n in SHAPES]).copy()
    )
    t_params, t_ema = flat(params), flat(params)
    t_state = ours.init(t_params)
    for step in range(3):
        grads = {n: jnp.asarray(v) for n, v in
                 ((n, np.random.default_rng(50 + step).normal(size=s).astype(np.float32))
                  for n, s in SHAPES.items())}
        assert ours.lr_at(step) == pytest.approx(float(jax_lr_with_rampup(step, base, gbs, kimg)))
        params, j_state, ema = jax_opt.update_with_ema(grads, j_state, params, ema, ema_decay=0.99)
        ours.update_with_ema(flat(grads), t_state, t_params, t_ema, ema_decay=0.99)
    assert t_state.count == int(j_state[0].count) == 3
    for got, want in ((t_params, params), (t_ema, ema), (t_state.mu, j_state[0].mu),
                      (t_state.nu, j_state[0].nu)):
        np.testing.assert_allclose(got.numpy(), flat(want).numpy(), **TOL)


def test_narrow_nu_and_weight_decay_are_not_ported():
    """A bf16 nu is ported (with stochastic rounding); the JAX guards stay:
    nu_dtype with weight decay raises (state.py:93-97), and only bf16 is a
    narrow nu (fused_adam.py:335-339). The fused update takes no weight
    decay; ``fused=False`` is the staged update (tests/
    test_torch_staged_adam.py holds it to the JAX staged optimizer)."""
    assert make_optimizer(1e-4, 8, nu_dtype="bfloat16").nu_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="nu_dtype with weight_decay"):
        make_optimizer(1e-4, 8, nu_dtype="bfloat16", weight_decay=0.01)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_optimizer(1e-4, 8, nu_dtype="float16")
    with pytest.raises(ValueError, match="only bfloat16"):
        fused_adam.FusedAdamEma(1e-4, nu_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="wd=0"):
        make_optimizer(1e-4, 8, weight_decay=0.01)
    assert isinstance(make_optimizer(1e-4, 8, fused=False), fused_adam.StagedAdamEma)


def test_optimizer_state_from_flax_round_trip(tiny_dit_module):
    """optax Adam state -> the port's -> the same values under the param
    keys, in the layout of export_maskdit (Dense moments transposed)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    try:
        _, params, model = make_pair(True, 0.1, seed=20)
    finally:
        mp.undo()
    rng = np.random.default_rng(21)
    rand = lambda tree: jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), tree
    )
    adam = optax.adam(1e-4).init(params)[0]._replace(
        count=jnp.asarray(5, jnp.int32), mu=rand(params), nu=jax.tree.map(jnp.abs, rand(params))
    )
    opt = optimizer_state_from_flax(adam)
    assert opt["count"] == 5
    for key in ("mu", "nu"):
        want = export_maskdit(jax.tree.map(np.asarray, getattr(adam, key)))
        assert sorted(opt[key]) == sorted(want) == sorted(model.state_dict())
        for k, v in want.items():
            np.testing.assert_array_equal(opt[key][k].numpy(), v, err_msg=k)
    state = create_train_state(model, make_optimizer(1e-4, 4))
    state.load_opt_state(opt)
    assert state.opt_state.count == 5
    for k, v in state.named(state.opt_state.nu).items():
        np.testing.assert_array_equal(v.numpy(), opt["nu"][k].numpy(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("numel", [1 << 20, 1000003])
def test_cuda_kernel_matches_plain_version(numel, mu_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    gen = torch.Generator("cuda").manual_seed(0)
    rnd = lambda: torch.randn(numel, device="cuda", generator=gen)
    g, p, e, v = rnd(), rnd(), rnd(), rnd().abs() * 0.01
    m = (rnd() * 0.1).to(getattr(torch, mu_dtype))
    scalars = fused_adam.adam_scalars(1e-3, 7, 0.9, 0.999, 1e-8, 0.9999)
    want = fused_adam.fused_adam_ema_reference(g, p, m, v, e, **scalars)
    before = fused_adam.fused_adam_ema.launches
    fused_adam.fused_adam_ema(g, p, m, v, e, lr=1e-3, count_inc=7)
    torch.cuda.synchronize()
    assert fused_adam.fused_adam_ema.launches == before + 1
    # fp32 FMA contraction only; a bf16 mu may round one ulp the other way
    for got, ref in zip((p, v, e), (want[0], want[2], want[3])):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(m.float(), want[1].float(), rtol=1e-2 if mu_dtype == "bfloat16" else 1e-6,
                               atol=1e-7)
