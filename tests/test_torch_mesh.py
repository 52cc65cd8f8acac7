"""The port's mesh (parallel/mesh.py, parallel/sharded.py) in one process.

At the tiny dims of ``tiny_dit`` (4 heads, width 64, a 2 x 64 x 4 decoder),
fp32 on the CPU:

  * the partition rules: the port's spec of every parameter against the JAX
    ``param_specs`` of the same model, carried to the ``(out, in)`` layout,
    and ``fit_spec`` against the JAX ``_fit_spec`` over a grid of shapes and
    mesh sizes; the one named difference, qkv split by whole heads;
  * ``shard_state_dict`` -> ``gather_state_dict`` bit for bit on several
    meshes, each shard the shape of its tensor rank's module;
  * the tensor-parallel ``Attention`` and ``Mlp``: each rank's output with
    the tensor sum taken out, summed by hand, is the whole layer's;
  * kernel #7's plain version on each rank's shards with the layout's
    segment table against the unsharded plain update, bit for bit, its
    stochastic rounding of a bf16 nu included (and the staged update);
  * the attention route at the local head count (C10: the kernels where
    the JAX package, its packed layout split over tensor, runs plain
    attention);
  * a sharded state after a train step, once dropped, is freed by the
    garbage collector with its model (its gradient hooks hold it weakly).

The steps on the mesh, against one process and the JAX step, run under
``torch.distributed.run`` in tests/test_torch_mesh_dist.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.ops.dispatch import shard_safe_kernel
from maskdit_tpu.parallel import mesh as jax_mesh
from maskdit_tpu_torch.models import create_model, layers
from maskdit_tpu_torch.models.layers import Attention, Mlp, TensorSplit, attention_route
from maskdit_tpu_torch.ops import fused_adam
from maskdit_tpu_torch.parallel import mesh as mesh_lib
from maskdit_tpu_torch.parallel.sharded import ShardLayout
from maskdit_tpu_torch.utils.port import gather_state_dict, shard_state_dict, state_dict_from_flax
from tests.test_torch_model import patch_tiny_port

RES, CIN, K = 8, 4, 6
MODEL_KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
                use_decoder=True, mae_loss_coef=0.1)
MESHES = [{"data": 2, "fsdp": 2}, {"fsdp": 2, "tensor": 2}, {"data": 2, "tensor": 2},
          {"fsdp": 4}, {"tensor": 4}, {"data": 1, "fsdp": 2, "tensor": 4}]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch intra-op thread per test: these tiny dims run hundreds of
    small ops, which a pool of threads per xdist worker only slows."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def tiny(tiny_dit_module):
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    torch.manual_seed(0)
    model = create_model("edm", dtype=torch.float32, use_flash=False, **MODEL_KW)
    yield model, {k: v.clone() for k, v in model.state_dict().items()}
    mp.undo()


def _jax_params():
    model = jax_create_model("edm", dtype=jnp.float32, use_flash=False, **MODEL_KW)
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K)),
        mask_ratio=0.5, train=True))["params"]


class _Shape:
    """What ``_fit_spec`` reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


def _port_of_jax_spec(spec, ndim: int, jax_ndim: int) -> tuple:
    """A JAX leaf's spec in the port's layout: a Dense kernel (in, out) is
    the weight (out, in); a bias keeps its dim; any other leaf is whole."""
    parts = [None] * (jax_ndim - len(spec)) + list(spec)
    if jax_ndim == 2:
        return tuple(reversed(parts))
    if jax_ndim == 1:
        return tuple(parts)
    assert all(p is None for p in parts), parts
    return (None,) * ndim


@pytest.mark.parametrize("shape", MESHES[:4], ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_param_specs_are_the_jax_rules_in_the_port_layout(tiny, shape):
    """Every parameter's fitted spec equals the JAX one of the same leaf
    (found by tagging each JAX leaf with its index and reading the tag
    back from ``state_dict_from_flax``). The specs cannot show the qkv
    difference: both split qkv's output features over tensor; the JAX
    package by contiguous columns, the port by whole heads (the next
    test)."""
    shapes = _jax_params()
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    tag_of = {k: int(v.reshape(-1)[0]) for k, v in state_dict_from_flax(tagged).items()}
    jax_specs = jax.tree_util.tree_leaves(jax_mesh.param_specs(shapes),
                                          is_leaf=lambda x: isinstance(x, P))
    full_shape = {a: shape.get(a, 1) for a in mesh_lib.AXES}
    port_specs = mesh_lib.param_specs(list(tag_of))
    _, full = tiny
    assert set(tag_of) == set(full)
    for key, i in tag_of.items():
        want = jax_mesh._fit_spec(jax_specs[i], leaves[i].shape, _Shape(full_shape))
        got = mesh_lib.fit_spec(port_specs[key], full[key].shape, full_shape)
        assert got == _port_of_jax_spec(tuple(want), full[key].dim(), len(leaves[i].shape)), key


def test_qkv_splits_by_whole_heads():
    """The named difference: rank t of T holds rows [q | k | v] of heads
    [t H/T, (t+1) H/T), three runs, where the JAX rule's contiguous block
    would be one run of the packed features."""
    d, size = 64, 2
    assert mesh_lib.tensor_runs("model.blocks.0.attn.qkv.weight", 3 * d, 1, size) == [
        (32, 64), (96, 128), (160, 192)]
    assert mesh_lib.tensor_runs("model.blocks.0.attn.qkv.bias", 3 * d, 0, size) == [
        (0, 32), (64, 96), (128, 160)]
    assert mesh_lib.tensor_runs("model.blocks.0.mlp.fc1.weight", 4 * d, 1, size) == [(128, 256)]


def test_fit_spec_is_the_jax_fit_spec_over_a_grid():
    specs = [P(), P("fsdp"), P("tensor"), P("fsdp", "tensor"), P("tensor", "fsdp"),
             P(None, "fsdp"), P("fsdp", None), P(("data", "fsdp")), P("data", "tensor")]
    dims = [1, 2, 3, 4, 6, 8, 12, 96]
    checked = 0
    for sizes in [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2), (1, 4, 2), (1, 3, 1),
                  (2, 1, 4), (1, 1, 8)]:
        shape = dict(zip(mesh_lib.AXES, sizes))
        for spec in specs:
            for rank in (1, 2, 3):
                for dims_of in ([dims[i % len(dims)] for i in range(k, k + rank)]
                                for k in range(len(dims))):
                    want = jax_mesh._fit_spec(spec, tuple(dims_of), _Shape(shape))
                    assert mesh_lib.fit_spec(tuple(spec), dims_of, shape) == tuple(want)
                    checked += 1
    assert checked == 9 * 9 * 3 * 8


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_shard_then_gather_is_the_full_state_bit_for_bit(tiny, shape):
    _, full = tiny
    full_shape = mesh_lib.mesh_shape_of(shape, math.prod(shape.values()))
    shards = [shard_state_dict(full, full_shape, mesh_lib.coords_of(r, full_shape))
              for r in range(math.prod(shape.values()))]
    back = gather_state_dict(shards, full_shape, {k: v.shape for k, v in full.items()})
    assert set(back) == set(full)
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    # each tensor rank's module holds its shards' fsdp-gathered blocks
    size_t = full_shape["tensor"]
    for t in range(size_t):
        local = create_model("edm", dtype=torch.float32, use_flash=False,
                             tensor_split=TensorSplit(t, size_t), **MODEL_KW)
        layout = ShardLayout([(k, tuple(full[k].shape)) for k, _ in local.named_parameters()],
                             full_shape, {"data": 0, "fsdp": 0, "tensor": t})
        for (name, p), leaf in zip(local.named_parameters(), layout.leaves):
            assert tuple(p.shape) == leaf.local_shape, name
            assert tuple(shards[t][name].shape) == leaf.shard_shape, name


def _split_module(whole, make, size: int, prefix: str):
    """Each tensor rank's copy of ``whole`` (its weights sharded by the
    rules under ``prefix``)."""
    state = {f"{prefix}.{k}": v for k, v in whole.state_dict().items()}
    shape = {"data": 1, "fsdp": 1, "tensor": size}
    out = []
    for t in range(size):
        shards = shard_state_dict(state, shape, {"data": 0, "fsdp": 0, "tensor": t})
        part = make(TensorSplit(t, size))
        part.load_state_dict({k[len(prefix) + 1:]: v for k, v in shards.items()})
        out.append(part)
    return out


@pytest.mark.parametrize("size", [2, 4])
def test_tensor_parallel_layers_sum_to_the_whole_layer(monkeypatch, size):
    """fp32: the sum over the ranks of (output - bias) + bias, with the
    tensor group's sum taken out of each rank, is the whole layer's
    output (<= 1e-6 of max|whole|). Attention runs its plain route here,
    at the local head count."""
    monkeypatch.setattr(layers, "sum_over_tensor_group", lambda x, split: x.float())
    torch.manual_seed(3)
    x = torch.randn(3, 16, 64)
    cases = [
        (Attention(64, 4, use_flash=False),
         lambda s: Attention(64, 4, use_flash=False, split=s), "attn", "proj"),
        (Mlp(64, 256), lambda s: Mlp(64, 256, split=s), "mlp", "fc2"),
    ]
    for whole, make, prefix, out_layer in cases:
        parts = _split_module(whole, make, size, f"model.blocks.0.{prefix}")
        bias = getattr(whole, out_layer).bias.detach()
        with torch.no_grad():
            want = whole(x)
            got = sum(part(x) - bias for part in parts) + bias
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-6, (prefix, err)
        if prefix == "attn":
            assert parts[0].num_heads == 4 // size


@pytest.mark.parametrize("shape", [{"fsdp": 2, "tensor": 2}, {"fsdp": 4}, {"tensor": 4},
                                   {"data": 2, "fsdp": 2}],
                         ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("update", ["fused", "staged"])
def test_adam_on_shards_with_segments_is_the_unsharded_update_bit_for_bit(tiny, shape,
                                                                         update):
    """Kernel #7's plain version (and the staged update) on each rank's
    shard buffer, with the layout's segment table, equals the unsharded
    update of the flat buffer at the same elements, bit for bit: p, m, the
    stochastically rounded bf16 nu and the EMA. The table maps every
    element to its unsharded index, and the model ranks cover them all."""
    _, full = tiny
    shapes = [(k, tuple(v.shape)) for k, v in full.items()]
    n = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator().manual_seed(11)
    flat = {name: torch.randn(n, generator=g) * s for name, s in
            (("g", 1e-2), ("p", 1.0), ("m", 1e-3), ("v", 1e-5), ("e", 1.0))}
    flat["v"] = flat["v"].abs().bfloat16()

    def run(g_, p, m, v, e, segments=None):
        p, m, v, e = p.clone(), m.clone(), v.clone(), e.clone()
        if update == "fused":
            fused_adam.fused_adam_ema(g_, p, m, v, e, lr=1e-3, count_inc=5, ema_decay=0.99,
                                      segments=segments)
        else:
            fused_adam.staged_adam_ema(g_, p, m, v, e, lr=1e-3, count=4, ema_decay=0.99,
                                       segments=segments)
        return p, m, v, e

    want = run(*(flat[k] for k in "gpmve"))
    full_shape = mesh_lib.mesh_shape_of(shape, math.prod(shape.values()))
    covered = torch.zeros(n, dtype=torch.bool)
    for r in range(math.prod(shape.values())):
        layout = ShardLayout(shapes, full_shape, mesh_lib.coords_of(r, full_shape))
        index = layout.global_index()
        assert layout.segments.shape[0] < 4 * len(shapes)  # a small table
        covered[index] = True
        got = run(*(flat[k][index] for k in "gpmve"), segments=layout.segments)
        for a, b, what in zip(got, want, "pmve"):
            assert torch.equal(a, b[index]), (r, what)
        # the shards as ``shard_state_dict`` cuts them are those elements
        named = {k: flat["p"][off:off + math.prod(s)].view(s) for (k, s), off in
                 zip(shapes, np.cumsum([0] + [math.prod(s) for _, s in shapes]))}
        shards = shard_state_dict(named, full_shape, mesh_lib.coords_of(r, full_shape))
        assert torch.equal(torch.cat([shards[k].reshape(-1) for k, _ in shapes]),
                           flat["p"][index])
    assert bool(covered.all())


# (model, tensor size, L, head dim, backward) -> the port's route where the
# JAX package runs plain attention: its tensor-sharded packed qkv has no
# per-device slice of whole heads (maskdit_tpu/ops/dispatch.py:96-99). The
# port splits qkv by whole heads, so each rank runs the kernels at H/T
# heads (ROADMAP C10).
NAMED_MESH_DIFFERENCES = {
    ("DiT-XL/2 encoder, 256 px, mask 0.5", 2, 128, 72, True): "packed",
    ("DiT-XL/2 decoder, 256 px", 2, 256, 32, True): "packed",
    ("DiT-XL/2 encoder, 512 px, mask 0.5", 2, 512, 72, True): "big",
    ("DiT-XL/2 decoder, 512 px", 2, 1024, 32, True): "big",
    ("DiT-XL/2 encoder, 256 px, mask 0.5", 4, 128, 72, True): "packed",
    ("DiT-XL/2 decoder, 256 px", 4, 256, 32, False): "packed",
}


def test_route_at_local_heads_is_named_difference_c10():
    """``attention_route`` at H/T heads (XL/2: 16 heads) takes the kernels;
    the JAX dispatch on a mesh with a tensor axis returns no kernel."""
    devices = np.asarray(jax.devices()[:2]).reshape(1, 1, 2)
    jax_choice = shard_safe_kernel(lambda q: q, JaxMesh(devices, mesh_lib.AXES), batch=8)
    assert jax_choice is None  # the JAX package's plain attention
    for (what, size, l, hd, backward), route in NAMED_MESH_DIFFERENCES.items():
        assert attention_route(16 // size, l, hd, backward) == route, what


def test_a_dropped_sharded_state_is_freed_with_its_model(tiny):
    """One train step on a sharded state of a mesh of one process (its
    collectives the identity), then nothing else holds it: the garbage
    collector frees the state, its buffers and the model. A tensor's
    post-accumulate-grad hooks are no roots the collector traverses, so
    the per-unit gradient hooks must not hold the state strongly (else
    every case of a run keeps its state on the card)."""
    import gc
    import weakref

    from maskdit_tpu_torch.parallel.sharded import create_sharded_state
    from maskdit_tpu_torch.train.state import make_optimizer, make_train_step

    _, full = tiny
    model = create_model("edm", dtype=torch.float32, use_flash=False, **MODEL_KW)
    opt = make_optimizer(1e-3, 4)
    state = create_sharded_state(model, full, opt, mesh_lib.create_mesh({"fsdp": 1}))
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1)
    rng = np.random.default_rng(3)
    batch = {"x": torch.from_numpy(rng.normal(size=(4, 2 * CIN, RES, RES)).astype(np.float32)),
             "y": torch.eye(K)[rng.integers(0, K, 4)]}
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"])) and all(u.reduced for u in state.units)
    refs = [weakref.ref(x) for x in (state, state.params, state.units[0].grad, model)]
    del state, model, step, metrics
    gc.collect()
    assert [r() is None for r in refs] == [True] * 4
