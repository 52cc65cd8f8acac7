"""Each layer of the PyTorch port against its flax counterpart.

Weights: every flax leaf drawn from a seeded normal (std 0.05, so the
zero-initialised adaLN and output layers matter too), carried across with
the export rules (Dense kernels transposed, the patch kernel permuted).
Everything runs in fp32 on the CPU; the bound is 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import layers as jl
from maskdit_tpu_torch.models import layers as tl

ATOL = 1e-5
D, HEADS, C_EMB = 32, 4, 48


def _random_params(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0.0, 0.05, size=x.shape).astype(np.float32), shapes
    )


def _apply(module, params, *args):
    return jax.jit(module.apply)({"params": params}, *args)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# flax submodule names -> the reference's torch names
_RENAME = {"adaLN_modulation": "adaLN_modulation.1", "fc1@t": "mlp.0", "fc2@t": "mlp.2"}


def _to_torch(params, timestep=False, patch=False):
    """A flax layer's params -> the port layer's state dict."""
    state = {}
    for path, leaf in _flatten(params):
        leaf = np.asarray(leaf)
        if patch:
            name = "proj." + ("weight" if path[-1] == "kernel" else "bias")
            state[name] = leaf.transpose(3, 2, 0, 1) if path[-1] == "kernel" else leaf
            continue
        mods = [
            _RENAME.get(f"{p}@t" if timestep else p, _RENAME.get(p, p)) for p in path[:-1]
        ]
        if path[-1] == "kernel":
            state[".".join(mods + ["weight"])] = leaf.T
        else:
            state[".".join(mods + ["bias"])] = leaf
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), atol=atol)


def _x(*shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_gelu_tanh_is_torch_tanh_gelu():
    x = _x(1000) * 4
    _close(tl.gelu_tanh(torch.from_numpy(x)), jl.gelu_tanh(jnp.asarray(x)), atol=1e-6)
    torch.testing.assert_close(
        tl.gelu_tanh(torch.from_numpy(x)),
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh"),
        rtol=0, atol=0,
    )


def test_modulate_and_layer_norm():
    x, shift, scale = _x(2, 5, D), _x(2, D, seed=2), _x(2, D, seed=3)
    _close(
        tl.modulate(torch.from_numpy(x), torch.from_numpy(shift), torch.from_numpy(scale)),
        jl.modulate(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale)),
    )
    x = x * 3 + 1
    _close(tl.layer_norm_no_affine(torch.from_numpy(x)), jl.layer_norm_no_affine(jnp.asarray(x)))
    ln = torch.nn.LayerNorm(D, elementwise_affine=False, eps=1e-6)
    _close(tl.layer_norm_no_affine(torch.from_numpy(x)), ln(torch.from_numpy(x)).detach())


def test_timestep_embedding_and_pos_embed():
    t = np.array([0.0, 0.3, -1.7, 25.0], np.float32)
    for dim in (256, 33):
        _close(tl.timestep_embedding(torch.from_numpy(t), dim),
               jl.timestep_embedding(jnp.asarray(t), dim))
    np.testing.assert_array_equal(
        tl.get_2d_sincos_pos_embed(D, 4), jl.get_2d_sincos_pos_embed(D, 4)
    )


def test_timestep_embedder():
    t = np.array([0.1, -0.4, 1.3], np.float32)
    jm = jl.TimestepEmbedder(D)
    params = _random_params(jm, jnp.asarray(t))
    tm = tl.TimestepEmbedder(D)
    tm.load_state_dict(_to_torch(params, timestep=True))
    _close(tm(torch.from_numpy(t)), _apply(jm, params, jnp.asarray(t)))


def test_label_embedder_null_class_is_zero():
    y = np.eye(6, dtype=np.float32)[[0, 5, 2]]
    y[2] = 0.0  # CFG null class
    jm = jl.LabelEmbedder(6, D)
    params = _random_params(jm, jnp.asarray(y))
    tm = tl.LabelEmbedder(6, D)
    tm.load_state_dict(_to_torch(params))
    ours = tm(torch.from_numpy(y))
    _close(ours, _apply(jm, params, jnp.asarray(y)))
    assert torch.count_nonzero(ours[2]) == 0


def test_patch_embed():
    x = _x(2, 4, 8, 8)
    jm = jl.PatchEmbed(2, D)
    params = _random_params(jm, jnp.asarray(x))
    tm = tl.PatchEmbed(2, 4, D)
    tm.load_state_dict(_to_torch(params, patch=True))
    _close(tm(torch.from_numpy(x)), _apply(jm, params, jnp.asarray(x)))


@pytest.mark.parametrize("layer", ["attention", "mlp"])
def test_attention_and_mlp(layer):
    x = _x(2, 16, D)
    if layer == "attention":
        jm, tm = jl.Attention(D, HEADS, use_flash=False), tl.Attention(D, HEADS)
    else:
        jm, tm = jl.Mlp(D, 4 * D), tl.Mlp(D, 4 * D)
    params = _random_params(jm, jnp.asarray(x))
    tm.load_state_dict(_to_torch(params))
    _close(tm(torch.from_numpy(x)), _apply(jm, params, jnp.asarray(x)))


@pytest.mark.parametrize("layer", ["dit_block", "decoder_layer", "final_layer"])
def test_conditioned_layers(layer):
    x, c = _x(2, 16, D), _x(2, C_EMB, seed=4)
    if layer == "dit_block":
        jm = jl.DiTBlock(D, C_EMB, HEADS, use_flash=False)
        tm = tl.DiTBlock(D, C_EMB, HEADS)
    elif layer == "decoder_layer":
        # the decoder layer's adaLN reads c of the encoder width
        x = _x(2, 16, C_EMB)
        jm, tm = jl.DecoderLayer(C_EMB, D), tl.DecoderLayer(C_EMB, D)
    else:
        jm, tm = jl.FinalLayer(D, C_EMB, 2, 4), tl.FinalLayer(D, C_EMB, 2, 4)
    params = _random_params(jm, jnp.asarray(x), jnp.asarray(c))
    tm.load_state_dict(_to_torch(params))
    _close(
        tm(torch.from_numpy(x), torch.from_numpy(c)),
        _apply(jm, params, jnp.asarray(x), jnp.asarray(c)),
    )


def test_linear_computes_in_its_dtype():
    """Input, weight and bias are rounded to the compute dtype, as flax
    Dense(dtype=bfloat16) does; the parameters stay fp32."""
    lin = tl.Linear(8, 4, compute_dtype=torch.bfloat16)
    assert lin.weight.dtype == torch.float32
    x = torch.from_numpy(_x(3, 8))
    out = lin(x)
    assert out.dtype == torch.bfloat16
    ref = x.bfloat16().float() @ lin.weight.bfloat16().float().T + lin.bias.bfloat16().float()
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)
