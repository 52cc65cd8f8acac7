"""Activation rematerialisation (``remat``, models/remat.py) of the port's
DiT blocks, against no remat and against the JAX model's policies.

fp32 on the CPU at the ``tiny_dit`` dims (depth 2, width 64, 4 heads,
decoder 2 x 64 x 4), each test on 2 torch threads, the loss the sum of
squares of the masked training forward (mask 0.5, injected):

* every policy's loss and gradients equal the port's without remat bit for
  bit, on the packed route (its plain versions on the CPU), on the plain
  route (``use_flash=False``) and in bf16, and the packed route launches
  one more attention forward per block (the recompute), the same
  backwards; the JAX block's gradient holds likewise one more
  ``pallas_call`` per block under each policy; each block's recomputed
  values are freed when its backward is done;
* every policy against the JAX ``create_model(remat=policy)`` on the same
  weights (``state_dict_from_flax``): loss rtol 1e-6, gradients atol and
  rtol 1e-5, the bounds of tests/test_model.py's remat test;
* what one block keeps for its backward, seen through
  ``saved_tensors_hooks`` with the parameters left out: the JAX names the
  policy saves (h_msa, qkv_out, attn_out, h_mlp, fc1_out, mlp_out; ``dots``
  every GEMM's output) and the block's inputs, nothing else; the bytes
  fall from none to names, dots, names_lite and full;
* an unknown policy raises (the JAX model runs it without remat), and the
  mesh's ``create_sharded_state`` takes every policy;
* the blocked and flash routes: the tiny model at 64 x 64 latents (the
  encoder at L 512 on the packed route, the decoder at L 1024 on the
  blocked one; with ``use_flash`` both on the flash route), under every
  policy bit for bit with no remat, with one more forward per block on
  the packed and blocked routes, and on the flash route the same two
  forwards per block as without remat (the block's recompute takes the
  place of the layer's checkpoint).

Remat on the mesh is held in tests/test_torch_mesh_dist.py.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskdit_tpu.models import create_model as jax_create_model
from maskdit_tpu.models.masking import MaskInfo as JaxMaskInfo
from maskdit_tpu_torch.models import create_model, remat
from maskdit_tpu_torch.models.layers import DiTBlock, attention_route
from maskdit_tpu_torch.models.masking import MaskInfo, len_keep_for
from maskdit_tpu_torch.models.remat import policy_of
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big
from maskdit_tpu_torch.parallel.sharded import create_sharded_state
from maskdit_tpu_torch.utils.port import state_dict_from_flax
from tests.test_torch_model import patch_tiny_port

POLICIES = ["full", "dots", "names", "names_lite"]
RES, CIN, K, N = 8, 4, 6, 3
L = (RES // 2) ** 2
BLOCKS = 4  # 2 encoder + 2 decoder
KW = dict(img_resolution=RES, img_channels=CIN, num_classes=K, model_type="DiT-S/2",
          use_decoder=True, mae_loss_coef=0.1)
# what each policy keeps of a block, besides its inputs x and c (JAX
# dit.py:167-199; 'mod' is the adaLN Linear's output)
KEEPS = {
    "none": None,
    "names": {"h_msa", "qkv_out", "attn_out", "h_mlp", "fc1_out", "mlp_out"},
    "dots": {"mod", "qkv_out", "attn_out", "fc1_out", "mlp_out"},
    "names_lite": {"h_msa", "attn_out", "h_mlp", "mlp_out"},
    "full": set(),
}


@pytest.fixture(autouse=True)
def few_threads():
    was = torch.get_num_threads()
    torch.set_num_threads(min(was, 2))
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def case(tiny_dit_module):
    """The JAX parameters, inputs and mask, and the JAX loss and gradients
    of every policy (one jit)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, CIN, RES, RES)).astype(np.float32)
    sigma = np.array([0.3, 1.1, 6.0], np.float32)
    y = np.eye(K, dtype=np.float32)[[1, 4, 0]]
    shuffle = np.argsort(rng.random((N, L)), axis=1).astype(np.int32)
    restore = np.argsort(shuffle, axis=1).astype(np.int32)
    keep = len_keep_for(L, 0.5)
    mask = ((restore >= keep).astype(np.float32), shuffle[:, :keep], restore)
    models = {p: jax_create_model("edm", dtype=jnp.float32, use_flash=False, remat=p, **KW)
              for p in POLICIES}
    shapes = jax.eval_shape(lambda: models["full"].init(
        {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
        jnp.zeros((1, CIN, RES, RES)), jnp.ones((1,)), jnp.zeros((1, K))))["params"]
    params = jax.tree.map(lambda a: rng.normal(0.0, 0.05, size=a.shape).astype(np.float32),
                          shapes)
    info = JaxMaskInfo(*(jnp.asarray(a) for a in mask))

    def loss(model, p):
        out = model.apply({"params": p}, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(y),
                          mask_ratio=0.5, train=True, mask_info=info)
        return jnp.sum(out["x"] ** 2)

    jax_out = jax.jit(lambda p: {k: jax.value_and_grad(lambda q, m=m: loss(m, q))(p)
                                 for k, m in models.items()})(params)
    yield dict(params=params, inputs=(x, sigma, y), mask=mask, jax=jax_out)
    mp.undo()


def port_step(case, policy, use_flash=None, dtype=torch.float32):
    """The port's loss and gradients (by parameter name) under ``policy``."""
    model = create_model("edm", dtype=dtype, use_flash=use_flash, remat=policy, **KW)
    model.load_state_dict(state_dict_from_flax(case["params"]))
    x, sigma, y = (torch.from_numpy(a) for a in case["inputs"])
    info = MaskInfo(*(torch.from_numpy(a) for a in case["mask"]))
    loss = model(x, sigma, y, mask_ratio=0.5, mask_info=info, train=True)["x"].square().sum()
    loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_equals_no_remat_bit_for_bit_with_one_more_forward(case, policy, monkeypatch):
    launches = {"fwd": 0, "bwd": 0}

    def counting(fn, key):
        def run(*args):
            launches[key] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(flash_batched, "packed_attention_reference",
                        counting(flash_batched.packed_attention_reference, "fwd"))
    monkeypatch.setattr(flash_batched, "packed_attention_bwd_reference",
                        counting(flash_batched.packed_attention_bwd_reference, "bwd"))
    loss0, grads0 = port_step(case, "none")
    assert launches == {"fwd": BLOCKS, "bwd": BLOCKS}
    loss, grads = port_step(case, policy)
    # the recompute reruns each block's attention forward (JAX: three
    # pallas_calls per block's grad under a policy, two without)
    assert launches == {"fwd": 3 * BLOCKS, "bwd": 2 * BLOCKS}
    assert loss == loss0
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_on_the_plain_route_equals_no_remat_bit_for_bit(case, policy):
    loss0, grads0 = port_step(case, "none", use_flash=False)
    loss, grads = port_step(case, policy, use_flash=False)
    assert loss == loss0
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_in_bf16_equals_no_remat_bit_for_bit(case, policy):
    """bf16 compute, as on the card: the Linear weights' casts, which no
    policy keeps, are cast again in the backward to the same bits."""
    loss0, grads0 = port_step(case, "none", dtype=torch.bfloat16)
    loss, grads = port_step(case, policy, dtype=torch.bfloat16)
    assert loss == loss0
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_the_jax_models(case, policy):
    loss, grads = port_step(case, policy)
    jax_loss, jax_grads = case["jax"][policy]
    np.testing.assert_allclose(loss, float(jax_loss), rtol=1e-6)
    want = state_dict_from_flax(jax_grads)
    assert set(want) == set(grads)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def count_pallas_calls(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            n += 1
            continue
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += count_pallas_calls(inner)
    return n


def test_every_jax_policy_reruns_the_attention_kernel(monkeypatch):
    """Why each policy launches one more attention forward per block: the
    JAX block on its Pallas kernel (the TPU route, traced in interpret
    mode) has three pallas_calls in its gradient under every policy (the
    forward, its recompute, the backward) and two without remat, since
    proj's weight gradient needs the kernel's output, which no policy
    keeps."""
    import flax.linen as nn

    from maskdit_tpu.models.layers import DiTBlock as JaxBlock

    monkeypatch.setenv("MASKDIT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    x, c = jnp.ones((2, 128, 64)), jnp.ones((2, 64))
    names = {"names": ("h_msa", "qkv_out", "attn_out", "h_mlp", "fc1_out", "mlp_out"),
             "names_lite": ("h_msa", "attn_out", "h_mlp", "mlp_out")}
    counts = {}
    for policy in ["none", *POLICIES]:
        cls = JaxBlock if policy == "none" else nn.remat(JaxBlock, policy={
            "full": None, "dots": jax.checkpoint_policies.checkpoint_dots}.get(
            policy, jax.checkpoint_policies.save_only_these_names(*names.get(policy, ()))))
        block = cls(64, 64, 4, dtype=jnp.bfloat16)
        variables = jax.eval_shape(block.init, jax.random.PRNGKey(0), x, c)
        grad = jax.grad(lambda v: jnp.sum(block.apply(v, x, c).astype(jnp.float32)))
        counts[policy] = count_pallas_calls(jax.make_jaxpr(grad)(variables).jaxpr)
    assert counts == {"none": 2, **{p: 3 for p in POLICIES}}


def block_saves(policy):
    """One block's saved tensors (parameters left out) as the JAX names
    of what they are, and their bytes (each storage once)."""
    torch.manual_seed(0)
    block = DiTBlock(64, 64, 4, remat=policy)
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0.0, 0.05)
    x = torch.randn(2, 16, 64, requires_grad=True) * 1.0
    c = torch.randn(2, 64, requires_grad=True) * 1.0
    named = {"x": x, "c": c}

    def tap(inp, out):
        def hook(module, args, result):
            if inp:
                named.setdefault(inp, args[0])
            named.setdefault(out, result)
        return hook

    hooks = [m.register_forward_hook(tap(*names)) for m, names in (
        (block.adaLN_modulation[1], (None, "mod")), (block.attn.qkv, ("h_msa", "qkv_out")),
        (block.attn.proj, (None, "attn_out")), (block.mlp.fc1, ("h_mlp", "fc1_out")),
        (block.mlp.fc2, (None, "mlp_out")))]
    params = {p.untyped_storage().data_ptr() for p in block.parameters()}
    saved = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in params:
            saved[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = block(x, c)
    for h in hooks:
        h.remove()
    out.square().sum().backward()  # the saves serve a working backward
    by_storage = {t.untyped_storage().data_ptr(): k for k, t in named.items()}
    return {by_storage.get(ptr, "other") for ptr in saved}, sum(saved.values())


@pytest.mark.parametrize("policy", [p for p in KEEPS if p != "none"])
def test_a_block_keeps_what_the_policy_names(policy):
    kept, _ = block_saves(policy)
    assert kept == KEEPS[policy] | {"x", "c"}


def test_the_kept_bytes_fall_from_none_to_full():
    sizes = [block_saves(p)[1] for p in KEEPS]
    assert sizes == sorted(sizes, reverse=True) and len(set(sizes)) == len(sizes), sizes


@pytest.mark.parametrize("policy", POLICIES)
def test_each_blocks_recompute_is_freed_after_its_backward(policy, monkeypatch):
    """A block's frame, which holds what its backward recomputed, dies
    when the block's backward is done, while the graph (and the loss) live
    on: the recomputed activations never pile up over the blocks."""
    frames = []
    init = remat._Frame.__init__

    def recording(self, *args):
        init(self, *args)
        frames.append(weakref.ref(self))

    monkeypatch.setattr(remat._Frame, "__init__", recording)
    torch.manual_seed(0)
    blocks = [DiTBlock(64, 64, 4, remat=policy) for _ in range(3)]
    x = torch.randn(2, 16, 64, requires_grad=True)
    c = torch.randn(2, 64, requires_grad=True)
    seen = []
    h = x
    for i, block in enumerate(blocks):
        h = block(h, c)
        if i < 2:  # block i's output: its hook fires when block i + 1's backward is done
            h.register_hook(lambda g: seen.append([f() is None for f in frames]))
    loss = h.square().sum()
    loss.backward()
    assert len(frames) == 3
    assert seen == [[False, False, True], [False, True, True]]
    assert all(f() is None for f in frames) and loss.grad_fn is not None


def test_an_unknown_policy_raises_and_the_jax_values_map():
    assert [policy_of(v) for v in (False, "none", None, True, "full", "dots", "names",
                                   "names_lite")] == [None, None, None, "full", "full", "dots",
                                                      "names", "names_lite"]
    with pytest.raises(ValueError, match="unknown remat policy 'name_lite'"):
        create_model("edm", dtype=torch.float32, remat="name_lite", **KW)


@pytest.mark.parametrize("remat", [True, *POLICIES])
def test_the_mesh_state_takes_every_policy(case, remat):
    """``create_sharded_state`` builds the state of a model under each JAX
    value (here a one-rank mesh, no process group; the steps on 4 ranks are
    in tests/test_torch_mesh_dist.py), and refuses a block whose ``remat``
    was set to no policy, naming it."""
    from maskdit_tpu_torch.parallel.mesh import create_mesh
    from maskdit_tpu_torch.train.state import make_optimizer

    model = create_model("edm", dtype=torch.float32, remat=remat, **KW)
    full = dict(model.state_dict())
    state = create_sharded_state(model, full, make_optimizer(1e-3, N), create_mesh())
    assert {b.remat for b in [*model.model.blocks, *model.model.decoder_blocks]} == {
        policy_of(remat)}
    assert len(state.units) == BLOCKS
    model.model.blocks[1].remat = "name_lite"
    with pytest.raises(ValueError, match="model.blocks.1: remat='name_lite' is no policy"):
        create_sharded_state(model, full, make_optimizer(1e-3, N), create_mesh())


ROUTE_RES = 64  # 64 x 64 latents: L 1024, the encoder keeps 512 at mask 0.5
ROUTE_KW = {**KW, "img_resolution": ROUTE_RES}
# the plain versions each route's wrapper calls on the CPU, by kernel
ROUTE_PLAIN = {"packed_fwd": (flash_batched, "packed_attention_reference"),
               "packed_bwd": (flash_batched, "packed_attention_bwd_reference"),
               "big_fwd": (flash_big, "packed_attention_big_reference"),
               "big_bwd": (flash_big, "packed_attention_big_bwd_reference"),
               "flash_fwd": (flash, "flash_fwd_reference"),
               "flash_bwd": (flash, "flash_bwd_reference")}
ENCODER_BLOCKS = DECODER_BLOCKS = 2


@pytest.fixture(scope="module")
def route_case(tiny_dit_module):
    """The tiny port at 64 x 64 latents: seeded weights and one sample's
    inputs and mask (the smallest batch that reaches the routes)."""
    mp = pytest.MonkeyPatch()
    patch_tiny_port(mp)
    rng = np.random.default_rng(5)
    l_full = (ROUTE_RES // 2) ** 2
    shuffle = np.argsort(rng.random((1, l_full)), axis=1).astype(np.int32)
    restore = np.argsort(shuffle, axis=1).astype(np.int32)
    keep = len_keep_for(l_full, 0.5)
    model = create_model("edm", dtype=torch.float32, **ROUTE_KW)
    weights = {k: torch.from_numpy(rng.normal(0.0, 0.05, size=tuple(v.shape))
                                   .astype(np.float32))
               for k, v in model.state_dict().items()}
    yield dict(
        weights=weights, keep=keep,
        inputs=(rng.normal(size=(1, CIN, ROUTE_RES, ROUTE_RES)).astype(np.float32),
                np.array([1.3], np.float32), np.eye(K, dtype=np.float32)[[2]]),
        mask=((restore >= keep).astype(np.float32), shuffle[:, :keep], restore))
    mp.undo()


def route_step(route_case, policy, use_flash, monkeypatch):
    """The tiny 64 x 64 model's loss and gradients under ``policy``, and the
    plain versions' calls by kernel."""
    calls = dict.fromkeys(ROUTE_PLAIN, 0)
    for name, (module, attr) in ROUTE_PLAIN.items():
        def counted(*args, _name=name, _fn=getattr(module, attr)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(module, attr, counted)
    model = create_model("edm", dtype=torch.float32, use_flash=use_flash, remat=policy,
                         **ROUTE_KW)
    model.load_state_dict(route_case["weights"])
    x, sigma, y = (torch.from_numpy(a) for a in route_case["inputs"])
    info = MaskInfo(*(torch.from_numpy(a) for a in route_case["mask"]))
    loss = model(x, sigma, y, mask_ratio=0.5, mask_info=info, train=True)["x"].square().sum()
    loss.backward()
    monkeypatch.undo()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()}, calls


@pytest.mark.parametrize("use_flash", [None, True], ids=["blocked", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_on_the_blocked_and_flash_routes_equals_no_remat(route_case, policy,
                                                                use_flash, monkeypatch):
    """At 64 x 64 latents by default the encoder (L 512, hd 16) takes the
    packed route and the decoder (L 1024) the blocked one: each policy
    launches one more forward per block on both; with ``use_flash`` every
    block takes the flash route, two forwards per block with and without
    remat. Loss and gradients equal no remat's bit for bit."""
    keep = route_case["keep"]
    assert keep == 512
    if use_flash:
        assert {attention_route(4, l, 16, True, True) for l in (keep, 2 * keep)} == {"flash"}
    else:
        assert [attention_route(4, l, 16, True) for l in (keep, 2 * keep)] == ["packed", "big"]
    loss0, grads0, calls0 = route_step(route_case, "none", use_flash, monkeypatch)
    loss, grads, calls = route_step(route_case, policy, use_flash, monkeypatch)
    blocks = ENCODER_BLOCKS + DECODER_BLOCKS
    if use_flash:
        want0 = want = dict.fromkeys(ROUTE_PLAIN, 0) | {"flash_fwd": 2 * blocks,
                                                         "flash_bwd": blocks}
    else:
        want0 = dict.fromkeys(ROUTE_PLAIN, 0) | {
            "packed_fwd": ENCODER_BLOCKS, "packed_bwd": ENCODER_BLOCKS,
            "big_fwd": DECODER_BLOCKS, "big_bwd": DECODER_BLOCKS}
        want = want0 | {"packed_fwd": 2 * ENCODER_BLOCKS, "big_fwd": 2 * DECODER_BLOCKS}
    assert (calls0, calls) == (want0, want)
    assert loss == loss0
    for k, g in grads0.items():
        assert torch.equal(grads[k], g), k
