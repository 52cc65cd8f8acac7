"""Sharded training on the (data, fsdp, tensor) mesh: the state and the step.

Counterpart of maskdit_tpu/parallel/sharded.py (``create_sharded_state``,
``make_sharded_train_step``), which jits the train step with
NamedShardings and lets GSPMD place the collectives. Here they are written
out over ``torch.distributed`` (``parallel/mesh.py``):

  * the model is the one of this rank's tensor coordinate (``models/
    layers.py``: its blocks at H/T heads and 1/T of the MLP, a sum over the
    tensor group after proj and fc2);
  * the parameters, the gradient accumulator, the EMA and Adam's mu and nu
    are each ONE flat buffer of this rank's shards (``ShardLayout``): every
    leaf's tensor-local block, cut along its fsdp dim by the JAX rules
    (``mesh.DEFAULT_PARAM_RULES``, ``fit_spec``), in the model's parameter
    order. So the fused Adam + EMA update (kernel #7) is one launch over the
    shards, and its stochastic rounding of nu takes each element's index in
    the unsharded buffer from the layout's segment table;
  * each block is an FSDP unit: its parameters are all-gathered over the
    fsdp group into a buffer of the block's own before its forward, the
    buffer's storage is freed after it, and gathered again when the
    gradient reaches the block's output, for its backward. The other
    parameters (embedders, decoder and final layers) form one root unit,
    gathered for each micro-batch;
  * after each micro-batch's backward the gradient is reduced in fp32: a
    reduce-scatter over fsdp for the leaves split there, a sum over fsdp for
    the others; added into the accumulator (in its dtype), then averaged
    over data x fsdp by ``DataParallel(mesh)`` at the end of the step. A
    leaf replicated over tensor has the same gradient on every tensor rank
    (the sums make the activations and their gradients equal), so it is
    counted once;
  * ``grad_norm`` is the norm of the whole gradient: each leaf's shard
    weighted by 1/(ranks of the fsdp x tensor group that hold it), summed
    over that group.

A checkpoint is the full ``{model, ema, opt, step}`` of ``TrainState``,
gathered from every rank's shards (``utils.port.gather_state_dict``), so it
resumes on any mesh and on one process; a restore shards the full dicts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from maskdit_tpu_torch.ops.fused_adam import FusedAdamEma, segment_index
from maskdit_tpu_torch.parallel import mesh as mesh_lib
from maskdit_tpu_torch.parallel.data_parallel import DataParallel
from maskdit_tpu_torch.train.state import TrainState, _copy_named, make_train_step
from maskdit_tpu_torch.utils.port import gather_state_dict, leaf_split, shard_state_dict


@dataclasses.dataclass
class Leaf:
    """One parameter on this rank: its full shape and offset in the
    unsharded flat buffer, its split (tensor dim, fsdp dim), the block this
    rank's module holds (``local_shape``), the shard of that block this rank
    stores (``shard_shape`` at ``shard_offset`` of the shard buffer), and
    how many ranks of the fsdp x tensor group store the same elements."""

    name: str
    shape: tuple
    offset: int
    dim_t: Optional[int]
    dim_f: Optional[int]
    local_shape: tuple
    shard_shape: tuple
    shard_offset: int
    replicas: int

    @property
    def shard_numel(self) -> int:
        return math.prod(self.shard_shape)

    @property
    def local_numel(self) -> int:
        return math.prod(self.local_shape)


class ShardLayout:
    """The shards of one rank of a mesh of ``mesh_shape``: ``shapes`` are
    the full model's (name, shape) in parameter order."""

    def __init__(self, shapes: list[tuple[str, tuple]], mesh_shape: dict, coords: dict,
                 rules: Optional[list] = None):
        self.mesh_shape, self.coords, self.rules = mesh_shape, coords, rules
        specs = mesh_lib.param_specs([n for n, _ in shapes], rules)
        t_size, f_size = mesh_shape["tensor"], mesh_shape["fsdp"]
        self.leaves: list[Leaf] = []
        offset = shard_offset = 0
        for name, shape in shapes:
            shape = tuple(shape)
            dim_t, dim_f = leaf_split(name, shape, specs[name], mesh_shape)
            local = list(shape)
            if dim_t is not None:
                local[dim_t] //= t_size
            shard = list(local)
            if dim_f is not None:
                shard[dim_f] //= f_size
            replicas = (t_size if dim_t is None else 1) * (f_size if dim_f is None else 1)
            leaf = Leaf(name, shape, offset, dim_t, dim_f, tuple(local), tuple(shard),
                        shard_offset, replicas)
            self.leaves.append(leaf)
            offset += math.prod(shape)
            shard_offset += leaf.shard_numel
        self.numel = shard_offset
        self.full_numel = offset
        self.segments = self._segments()

    @property
    def named_shapes(self) -> dict[str, tuple]:
        return {leaf.name: leaf.shape for leaf in self.leaves}

    def named(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-leaf views of a shard buffer, under the state-dict keys."""
        return {leaf.name: flat[leaf.shard_offset:leaf.shard_offset + leaf.shard_numel]
                .view(leaf.shard_shape) for leaf in self.leaves}

    def shard(self, full: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's shards of a full state dict (its keys only)."""
        return shard_state_dict(full, self.mesh_shape, self.coords, self.rules)

    def _segments(self) -> torch.Tensor:
        """(local start, global start, rows, cols, row stride) rows mapping
        each shard element to its index in the unsharded flat buffer,
        sorted by local start, adjacent runs merged."""
        t, size_t = self.coords["tensor"], self.mesh_shape["tensor"]
        f, size_f = self.coords["fsdp"], self.mesh_shape["fsdp"]
        entries = []
        for leaf in self.leaves:
            if len(leaf.shape) == 1:  # a row vector: its split is on the columns
                rows_n, cols_n = 1, leaf.shape[0]
                dims = {"t": None if leaf.dim_t is None else 1,
                        "f": None if leaf.dim_f is None else 1}
            else:
                rows_n, cols_n = leaf.shape[0], math.prod(leaf.shape[1:])
                dims = {"t": leaf.dim_t, "f": leaf.dim_f}
                if (leaf.dim_t or 0) > 1 or (leaf.dim_f or 0) > 1:
                    raise ValueError(f"{leaf.name}: split beyond the first two dims")

            def runs(dim: int, n: int) -> list[tuple[int, int]]:
                if dims["t"] == dim:
                    return mesh_lib.tensor_runs(leaf.name, n, t, size_t)
                if dims["f"] == dim:
                    return [(f * n // size_f, (f + 1) * n // size_f)]
                return [(0, n)]

            row_runs, col_runs = runs(0, rows_n), runs(1, cols_n)
            if len(col_runs) > 1 and sum(b - a for a, b in row_runs) > 1:
                raise ValueError(f"{leaf.name}: several column runs on several rows")
            local = leaf.shard_offset
            for a, b in row_runs:
                for c, d in col_runs:
                    rows, cols = b - a, d - c
                    glob = leaf.offset + a * cols_n + c
                    if rows == 1 or cols == cols_n:  # one contiguous run
                        rows, cols = 1, rows * cols
                    entries.append([local, glob, rows, cols, cols_n if rows > 1 else cols])
                    local += rows * cols
        merged: list[list[int]] = []
        for e in entries:
            if merged:
                p = merged[-1]
                if (p[2] == 1 and e[2] == 1 and p[0] + p[3] == e[0]
                        and p[1] + p[3] == e[1]):
                    p[3] += e[3]
                    p[4] = p[3]
                    continue
            merged.append(e)
        return torch.tensor(merged, dtype=torch.int64).reshape(-1, 5)

    def global_index(self, device=None) -> torch.Tensor:
        """Every shard element's unsharded index (int64 on ``device``; to
        hold the shards to the unsharded buffer)."""
        return segment_index(self.segments, 0, self.numel, device)


class _Unit:
    """An FSDP unit: parameters gathered and freed together, into a buffer
    of their own (tensor-local leaves, in the module's order)."""

    def __init__(self, leaves: list[Leaf], params: list[nn.Parameter],
                 module: Optional[nn.Module] = None):
        self.leaves, self.params, self.module = leaves, params, module
        self.numel = sum(leaf.local_numel for leaf in leaves)
        self.full: Optional[torch.Tensor] = None
        self.gathered = False


class _GatherForBackward(torch.autograd.Function):
    """Identity forward on a block's output; its backward, which runs when
    the gradient reaches the block and before the block's own backward,
    gathers the block's parameters again."""

    @staticmethod
    def forward(ctx, x, state, unit):
        ctx.state, ctx.unit = state, unit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.state.gather(ctx.unit)
        return grad, None, None


@dataclasses.dataclass
class ShardedTrainState(TrainState):
    """``TrainState`` over this rank's shards (``params``, ``grads``, ``ema``
    and the moments are shard buffers; ``layout`` holds the shard shapes, so
    ``named`` gives shard views). The model's parameters are views into the
    units' gathered buffers, their ``.grad`` views into ``full_grads``."""

    mesh: Any = None
    shard_layout: Optional[ShardLayout] = None
    units: list = dataclasses.field(default_factory=list)
    root: Optional[_Unit] = None
    full_grads: Optional[torch.Tensor] = None

    collective = True  # checkpoint(), full_named() and the NaN check: every rank

    # -- gathering -----------------------------------------------------------------

    def _set_storage(self, t: torch.Tensor, on: bool) -> None:
        storage = t.untyped_storage()
        want = t.numel() * t.element_size() if on else 0
        if storage.nbytes() != want:
            storage.resize_(want)

    def gather(self, unit: _Unit) -> None:
        """All-gather ``unit``'s parameters over fsdp into its buffer (in the
        buffer's dtype: fp32, or bf16 under ``amp_grads``). The buffer is
        written through ``.data``: the parameters saved for the backward
        keep their version."""
        if unit.gathered:
            return
        self._set_storage(unit.full, True)
        full = unit.full.data
        shards = self.shard_layout.named(self.params)
        size_f = self.mesh.shape["fsdp"]
        split = [leaf for leaf in unit.leaves if leaf.dim_f is not None]
        gathered = None
        if split:
            send = torch.cat([shards[leaf.name].reshape(-1) for leaf in split])
            gathered = torch.empty(size_f * send.numel(), dtype=send.dtype, device=send.device)
            mesh_lib.all_gather(gathered, send, self.mesh, "fsdp")
            gathered = gathered.view(size_f, -1)
        off = pos = 0
        for leaf in unit.leaves:
            dst = full[off:off + leaf.local_numel].view(leaf.local_shape)
            if leaf.dim_f is None:
                dst.copy_(shards[leaf.name])
            else:
                piece = gathered[:, pos:pos + leaf.shard_numel].reshape(size_f, *leaf.shard_shape)
                dst.copy_(piece.movedim(0, leaf.dim_f).reshape(leaf.local_shape))
                pos += leaf.shard_numel
            off += leaf.local_numel
        unit.gathered = True

    def free(self, unit: _Unit) -> None:
        self._set_storage(unit.full, False)
        unit.gathered = False

    def _install_hooks(self) -> None:
        for unit in self.units:

            def pre(mod, args, unit=unit):
                self.gather(unit)

            def post(mod, args, out, unit=unit):
                if torch.is_grad_enabled() and out.requires_grad:
                    out = _GatherForBackward.apply(out, self, unit)
                self.free(unit)
                return out

            unit.module.register_forward_pre_hook(pre)
            unit.module.register_forward_hook(post)

    # -- TrainState's interface -----------------------------------------------------

    def bind(self, grad_dtype: torch.dtype, accum_dtype: torch.dtype) -> None:
        """The units' buffers and the full gradient in ``grad_dtype`` (the
        bf16 copy of the parameters under ``amp_grads`` is the gathered
        shards rounded once), the shard accumulator in ``accum_dtype``."""
        if self.binding == (grad_dtype, accum_dtype):
            return
        if self.grads.dtype != accum_dtype:
            self.grads = torch.zeros_like(self.params, dtype=accum_dtype)
        device = self.params.device
        total = sum(u.numel for u in self.all_units)
        self.full_grads = torch.zeros(total, dtype=grad_dtype, device=device)
        goff = 0
        for unit in self.all_units:
            unit.full = torch.empty(unit.numel, dtype=grad_dtype, device=device)
            off = 0
            for leaf, p in zip(unit.leaves, unit.params):
                n = leaf.local_numel
                p.data = unit.full[off:off + n].view(leaf.local_shape)
                p.grad = self.full_grads[goff:goff + n].view(leaf.local_shape)
                off += n
                goff += n
            self.free(unit)
        self._set_storage(self.full_grads, False)
        self.binding = (grad_dtype, accum_dtype)

    @property
    def all_units(self) -> list[_Unit]:
        return [self.root, *self.units]

    def begin_micro(self) -> None:
        """Before a micro-batch: the root unit gathered, the full gradient
        allocated and zero (each block gathers itself)."""
        self._set_storage(self.full_grads, True)
        self.full_grads.zero_()
        self.gather(self.root)

    def end_micro(self, acc_dtype: torch.dtype) -> None:
        """After a micro-batch's backward: its gradient reduced over fsdp in
        fp32 into this rank's shards and added into the accumulator; every
        unit and the full gradient freed."""
        grads = {}
        off = 0
        for unit in self.all_units:
            for leaf in unit.leaves:
                grads[leaf.name] = self.full_grads[off:off + leaf.local_numel].view(
                    leaf.local_shape)
                off += leaf.local_numel
        leaves = self.shard_layout.leaves
        size_f = self.mesh.shape["fsdp"]
        red = torch.empty(self.params.shape, dtype=torch.float32, device=self.params.device)
        out = self.shard_layout.named(red)
        split = [leaf for leaf in leaves if leaf.dim_f is not None]
        whole = [leaf for leaf in leaves if leaf.dim_f is None]
        if split:
            n = sum(leaf.shard_numel for leaf in split)
            send = torch.empty((size_f, n), dtype=torch.float32, device=red.device)
            pos = 0
            for leaf in split:
                g = grads[leaf.name].float().unflatten(leaf.dim_f, (size_f, -1))
                send[:, pos:pos + leaf.shard_numel].view(size_f, *leaf.shard_shape).copy_(
                    g.movedim(leaf.dim_f, 0))
                pos += leaf.shard_numel
            mine = torch.empty(n, dtype=torch.float32, device=red.device)
            mesh_lib.reduce_scatter_sum(mine, send, self.mesh, "fsdp")
            pos = 0
            for leaf in split:
                out[leaf.name].view(-1).copy_(mine[pos:pos + leaf.shard_numel])
                pos += leaf.shard_numel
        if whole:
            flat = torch.cat([grads[leaf.name].float().reshape(-1) for leaf in whole])
            mesh_lib.all_reduce_sum_(flat, self.mesh, "fsdp")
            pos = 0
            for leaf in whole:
                out[leaf.name].view(-1).copy_(flat[pos:pos + leaf.shard_numel])
                pos += leaf.shard_numel
        self.grads.add_(red.to(acc_dtype))
        for unit in self.all_units:
            self.free(unit)
        self._set_storage(self.full_grads, False)

    def grad_norm(self, grads: torch.Tensor) -> torch.Tensor:
        """The norm of the whole gradient (the mean over data is already in
        every replica): each shard's squared norm over its replicas in the
        fsdp x tensor group, summed over the group."""
        views = list(self.shard_layout.named(grads).values())
        norms = torch.stack(torch._foreach_norm([v.float() for v in views]))
        weights = torch.tensor([1.0 / leaf.replicas for leaf in self.shard_layout.leaves],
                               dtype=torch.float32, device=grads.device)
        total = (norms.square() * weights).sum().reshape(1)
        mesh_lib.all_reduce_sum_(total, self.mesh, "model")
        return total[0].sqrt()

    def any_rank(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is True on any (the NaN check)."""
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def full_named(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """The full state dict of a shard buffer, gathered from every rank
        (collective; on the CPU)."""
        mine = flat.detach().contiguous().view(torch.uint8)
        world = self.mesh.size
        everyone = torch.empty(world * mine.numel(), dtype=torch.uint8)
        if world == 1:
            everyone.copy_(mine.cpu())
        elif dist.get_backend() == "gloo":
            dist.all_gather_into_tensor(everyone, mine.cpu())
        else:
            on_card = torch.empty(world * mine.numel(), dtype=torch.uint8, device=flat.device)
            dist.all_gather_into_tensor(on_card, mine)
            everyone.copy_(on_card)
        chunks = everyone.view(world, -1)
        shards = [self.shard_layout.named(chunks[r].view(flat.dtype)) for r in range(world)]
        return gather_state_dict(shards, self.mesh.shape, self.shard_layout.named_shapes,
                                 self.shard_layout.rules)

    def checkpoint(self) -> dict[str, Any]:
        """``TrainState.checkpoint``'s full dict, gathered (every rank)."""
        return {
            "model": self.full_named(self.params),
            "ema": self.full_named(self.ema),
            "opt": {"count": self.opt_state.count, "mu": self.full_named(self.opt_state.mu),
                    "nu": self.full_named(self.opt_state.nu)},
            "step": self.step,
        }

    def _shard_checked(self, full: dict[str, torch.Tensor], what: str) -> dict:
        shapes = self.shard_layout.named_shapes
        known = {}
        for k, v in full.items():
            if k not in shapes:
                continue  # keys the model lacks are ignored
            if tuple(v.shape) != tuple(shapes[k]):
                raise ValueError(f"shape mismatch at {k}: ckpt {tuple(v.shape)} vs "
                                 f"model {tuple(shapes[k])}")
            known[k] = v
        return self.shard_layout.shard(known)

    def load(self, ckpt: dict[str, Any], strict: bool = True) -> list[str]:
        """``TrainState.load`` from a full checkpoint: each entry sharded
        (after the graft: a missing key keeps this rank's shard)."""
        missing = []
        with torch.no_grad():
            for key, flat in (("model", self.params), ("ema", self.ema)):
                if key in ckpt:
                    missing += _copy_named(self.named(flat),
                                           self._shard_checked(ckpt[key], key), key, strict)
            if "opt" in ckpt:
                self.load_opt_state(ckpt["opt"])
        if "step" in ckpt:
            self.step = int(ckpt["step"])
        return missing

    def load_opt_state(self, opt: dict[str, Any]) -> None:
        with torch.no_grad():
            _copy_named(self.named(self.opt_state.mu), self._shard_checked(opt["mu"], "opt.mu"),
                        "opt.mu")
            _copy_named(self.named(self.opt_state.nu), self._shard_checked(opt["nu"], "opt.nu"),
                        "opt.nu")
        self.opt_state.count = int(opt["count"])


def tensor_split_of(mesh: mesh_lib.Mesh):
    """The ``layers.TensorSplit`` of this rank (None without a tensor axis)."""
    from maskdit_tpu_torch.models.layers import TensorSplit

    if mesh.shape["tensor"] == 1:
        return None
    return TensorSplit(mesh.coords["tensor"], mesh.shape["tensor"], mesh.groups["tensor"])


def _block_modules(model: nn.Module) -> list[tuple[str, nn.Module]]:
    inner = model.model
    out = [(f"model.blocks.{i}", b) for i, b in enumerate(inner.blocks)]
    if getattr(inner, "decoder_blocks", None) is not None:
        out += [(f"model.decoder_blocks.{i}", b) for i, b in enumerate(inner.decoder_blocks)]
    return out


def create_sharded_state(model: nn.Module, full: dict[str, torch.Tensor],
                         optimizer: FusedAdamEma, mesh: mesh_lib.Mesh,
                         rules: Optional[list] = None) -> ShardedTrainState:
    """The train state of this rank: ``model`` is its tensor rank's model
    (``create_model(..., tensor_split=tensor_split_of(mesh))``) on its
    device, ``full`` the full model's state dict (every parameter; the same
    on every rank), whose shards become the parameters and the EMA.
    Adam's moments start at zero; the model's own initial values are
    dropped."""
    named = list(model.named_parameters())
    missing = [n for n, _ in named if n not in full]
    if missing:
        raise KeyError(f"no values for {missing[:5]} ({len(missing)} keys)")
    layout = ShardLayout([(n, tuple(full[n].shape)) for n, _ in named], mesh.shape,
                         mesh.coords, rules)
    for (name, p), leaf in zip(named, layout.leaves):
        if tuple(p.shape) != leaf.local_shape:
            raise ValueError(f"{name}: the module holds {tuple(p.shape)}, the mesh's rules "
                             f"give this rank {leaf.local_shape}")
    device = named[0][1].device
    params = torch.empty(layout.numel, dtype=torch.float32, device=device)
    with torch.no_grad():
        for k, v in layout.named(params).items():
            v.copy_(shard_state_dict({k: full[k]}, mesh.shape, mesh.coords, rules)[k])
    by_name = dict(zip((n for n, _ in named), layout.leaves))
    params_of = dict(named)
    units, in_blocks = [], set()
    for prefix, module in _block_modules(model):
        names = [f"{prefix}.{n}" for n, _ in module.named_parameters()]
        in_blocks.update(names)
        units.append(_Unit([by_name[n] for n in names], [params_of[n] for n in names], module))
    rest = [n for n, _ in named if n not in in_blocks]
    root = _Unit([by_name[n] for n in rest], [params_of[n] for n in rest])
    state = ShardedTrainState(
        step=0, model=model, params=params, grads=torch.zeros_like(params),
        ema=params.clone(), opt_state=optimizer.init(params),
        layout=[(leaf.name, torch.Size(leaf.shard_shape), leaf.shard_offset)
                for leaf in layout.leaves],
        binding=(None, None), segments=layout.segments.to(device),
        mesh=mesh, shard_layout=layout, units=units, root=root,
    )
    state.bind(torch.float32, torch.float32)
    state._install_hooks()
    return state


def make_sharded_train_step(optimizer: FusedAdamEma, mesh: mesh_lib.Mesh,
                            **step_kwargs: Any):
    """``train/state.make_train_step`` for a ``ShardedTrainState`` on
    ``mesh``: each rank takes the rows of its (data, fsdp) coordinate of
    the global batch (``batch_spec``; tensor ranks the same rows), with
    ``draw_step``'s draws of the whole global batch; micro-batches of
    ``grad_accum`` stay per rank. The gradient and the metrics are averaged
    over data x fsdp (``DataParallel(mesh)``)."""
    return make_train_step(optimizer, sync=DataParallel(mesh), **step_kwargs)
