"""The (data, fsdp, tensor) process mesh and its partition rules.

Counterpart of maskdit_tpu/parallel/mesh.py over ``torch.distributed``.
Axes, as the JAX mesh defines them:

  data   -- the batch is split, every parameter, moment and EMA whole on
            every rank;
  fsdp   -- the batch is split over data x fsdp as well; parameters, Adam's
            moments and the EMA are held as shards, each block's parameters
            gathered before its forward and again for its backward, the
            gradients reduce-scattered (``parallel/sharded.py``);
  tensor -- Megatron splits inside each DiT block (``models/layers.py``):
            qkv and fc1 by output features, proj and fc2 by input features,
            a sum over the tensor group after proj and fc2. Every rank of a
            tensor group sees the same rows.

Ranks map to coordinates with data outermost and tensor innermost, as
``create_mesh`` lays out its device array: rank = (d * fsdp + f) * tensor
+ t. So the ranks of a tensor group are neighbours.

The partition rules are the JAX ``DEFAULT_PARAM_RULES`` keyed on the port's
state-dict names, in the port's ``(out, in)`` weight layout: a JAX spec
P(a, b) of a Dense kernel (in, out) is ("b", "a") here. One difference is
named: JAX splits qkv's (D, 3D) kernel over tensor by contiguous columns,
and GSPMD re-lays out the heads (its dispatch then falls back to plain
attention); the port splits qkv by whole heads, rank t holding q, k and v
of heads [t H/T, (t+1) H/T) (``tensor_runs``). It computes the same
function.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "tensor")

# (state-dict key regex, per-dim axis names of the (out, in) weight); the
# first full match wins. The JAX rules (maskdit_tpu/parallel/mesh.py:87-113)
# transposed.
DEFAULT_PARAM_RULES: list[tuple[str, tuple]] = [
    # tensor-parallel splits inside the transformer blocks
    (r".*\.attn\.qkv\.weight", ("tensor", "fsdp")),
    (r".*\.attn\.qkv\.bias", ("tensor",)),
    (r".*\.attn\.proj\.weight", ("fsdp", "tensor")),
    (r".*\.mlp\.fc1\.weight", ("tensor", "fsdp")),
    (r".*\.mlp\.fc1\.bias", ("tensor",)),
    (r".*\.mlp\.fc2\.weight", ("fsdp", "tensor")),
    # big replicated matrices: the input dim over fsdp only
    (r".*\.adaLN_modulation\.1\.weight", (None, "fsdp")),
    (r".*decoder_layer\..*weight", (None, "fsdp")),
    (r".*final_layer\.linear\.weight", (None, "fsdp")),
    (r".*embedding_table\.weight", ("fsdp", None)),
    (r".*t_embedder\..*weight", ("fsdp", None)),
    # everything else replicated
    (r".*", ()),
]


def parse_mesh(text: Optional[str]) -> Optional[dict[str, int]]:
    """``data=a,fsdp=b,tensor=c`` (the train CLI's ``--mesh``, as train.py
    parses it) -> {axis: size}; None stays None. Axes left out are 1."""
    if not text:
        return None
    shape = {}
    for pair in text.split(","):
        name, sep, value = pair.partition("=")
        name = name.strip()
        if not sep or name not in AXES:
            raise ValueError(f"--mesh {text!r}: expected axis=size over {AXES}")
        shape[name] = int(value)
    return shape


@dataclasses.dataclass
class Mesh:
    """The mesh of this process: axis sizes, this rank's coordinates and one
    process group per axis (None where the group is the whole world or a
    single rank: then the collective runs on the default group or not at
    all)."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Optional[dist.ProcessGroup]]

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["fsdp"] * self.shape["tensor"]

    @property
    def batch_index(self) -> int:
        """This rank's block of the global batch: ``batch_spec`` splits the
        batch over its axes, the first major; tensor ranks share it."""
        index = 0
        for axis in batch_spec()[0]:
            index = index * self.shape[axis] + self.coords[axis]
        return index

    @property
    def batch_count(self) -> int:
        count = 1
        for axis in batch_spec()[0]:
            count *= self.shape[axis]
        return count

    @property
    def sharded(self) -> bool:
        """True where the state is split (an fsdp or tensor axis above 1)."""
        return self.shape["fsdp"] > 1 or self.shape["tensor"] > 1


def mesh_shape_of(mesh_shape: Optional[dict[str, int]], world: int) -> dict[str, int]:
    """The full axis sizes; the default puts every process on data. Raises
    where the product is not the number of processes (``create_mesh``'s
    check, maskdit_tpu/parallel/mesh.py:54-56)."""
    if mesh_shape is None:
        mesh_shape = {"data": world}
    unknown = set(mesh_shape) - set(AXES)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: expected {AXES}")
    shape = {a: int(mesh_shape.get(a, 1)) for a in AXES}
    if any(v < 1 for v in shape.values()):
        raise ValueError(f"mesh shape {mesh_shape}: sizes must be positive")
    if shape["data"] * shape["fsdp"] * shape["tensor"] != world:
        raise ValueError(f"mesh shape {mesh_shape} does not use all {world} processes")
    return shape


def coords_of(rank: int, shape: dict[str, int]) -> dict[str, int]:
    """A rank's (data, fsdp, tensor) coordinates, tensor innermost."""
    t = rank % shape["tensor"]
    f = (rank // shape["tensor"]) % shape["fsdp"]
    return {"data": rank // (shape["tensor"] * shape["fsdp"]), "fsdp": f, "tensor": t}


# groups of ranks that share every coordinate but those of ``axes``
_GROUP_AXES = {"data": ("data",), "fsdp": ("fsdp",), "tensor": ("tensor",),
               "batch": ("data", "fsdp"), "model": ("fsdp", "tensor")}


def create_mesh(mesh_shape: Optional[dict[str, int]] = None) -> Mesh:
    """This process's mesh over the process group (one process without a
    group: every axis 1). Every process must call it, with the same shape:
    it creates the groups of each axis (and of data x fsdp, ``batch``, and
    fsdp x tensor, ``model``) collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = mesh_shape_of(mesh_shape, world)
    coords = coords_of(rank, shape)
    groups: dict[str, Optional[dist.ProcessGroup]] = {}
    for name, axes in _GROUP_AXES.items():
        size = 1
        for a in axes:
            size *= shape[a]
        if size == 1 or size == world:
            groups[name] = None  # no collective, or the default group
            continue
        mine = None
        fixed = [a for a in AXES if a not in axes]
        seen = set()
        for r in range(world):  # every group, in one order on every rank
            c = coords_of(r, shape)
            key = tuple(c[a] for a in fixed)
            if key in seen:
                continue
            seen.add(key)
            members = [q for q in range(world)
                       if all(coords_of(q, shape)[a] == c[a] for a in fixed)]
            g = dist.new_group(members)
            if rank in members:
                mine = g
        groups[name] = mine
    return Mesh(shape, coords, groups)


def group_size(mesh: Mesh, name: str) -> int:
    size = 1
    for a in _GROUP_AXES[name]:
        size *= mesh.shape[a]
    return size


# -- collectives over a mesh axis (the identity on an axis of one rank); gloo takes
# CUDA tensors too, so ranks may share a card

def all_reduce_sum_(t: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """Sum ``t`` over the ``name`` group of the mesh, in place."""
    if group_size(mesh, name) > 1:
        dist.all_reduce(t, group=mesh.groups[name])
    return t


def all_gather(out: torch.Tensor, shard: torch.Tensor, mesh: Mesh, name: str) -> torch.Tensor:
    """Every rank's ``shard`` of the ``name`` group, in rank order, into the
    flat ``out`` (``group_size`` x ``shard.numel()``)."""
    if group_size(mesh, name) == 1:
        out.copy_(shard.reshape(-1))
    else:
        dist.all_gather_into_tensor(out, shard.reshape(-1).contiguous(),
                                    group=mesh.groups[name])
    return out


def reduce_scatter_sum(out: torch.Tensor, full: torch.Tensor, mesh: Mesh,
                       name: str) -> torch.Tensor:
    """The sum over the ``name`` group of ``full`` (``group_size`` blocks in
    rank order), this rank's block into ``out``."""
    if group_size(mesh, name) == 1:
        out.copy_(full.reshape(-1))
    else:
        dist.reduce_scatter_tensor(out, full.reshape(-1).contiguous(),
                                   group=mesh.groups[name])
    return out


# -- partition rules ----------------------------------------------------------------

def param_specs(names: Sequence[str], rules: Optional[list] = None) -> dict[str, tuple]:
    """Each state-dict key's spec by the first matching rule (the JAX
    ``param_specs``); divisibility is fixed up by ``fit_spec`` at use."""
    compiled = [(re.compile(pat), spec) for pat, spec in (rules or DEFAULT_PARAM_RULES)]
    out = {}
    for name in names:
        out[name] = next((spec for pat, spec in compiled if pat.fullmatch(name)), ())
    return out


def fit_spec(spec: tuple, shape: Sequence[int], mesh_shape: dict[str, int]) -> tuple:
    """Drop the axes whose size does not divide their dimension (or is 1),
    padding the spec's rank at the FRONT (the JAX ``_fit_spec``,
    maskdit_tpu/parallel/mesh.py:140-160)."""
    parts = [None] * (len(shape) - len(spec)) + list(spec)
    out = []
    for dim, axis in zip(shape, parts):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for a in axes:
            size *= mesh_shape[a]
        out.append(axis if size > 1 and dim % size == 0 else None)
    return tuple(out)


def batch_spec() -> tuple:
    """The batch dim over both data-like axes (data major)."""
    return (("data", "fsdp"),)


def tensor_runs(name: str, n: int, t: int, size: int) -> list[tuple[int, int]]:
    """The (start, stop) runs along the tensor dim (of length ``n``) of a
    tensor-split leaf that tensor rank ``t`` of ``size`` holds: qkv's
    [q | k | v] thirds by whole heads (the same block of each third), any
    other leaf one contiguous block."""
    if size == 1:
        return [(0, n)]
    if re.fullmatch(r".*\.attn\.qkv\.(weight|bias)", name):
        third = n // 3
        return [(k * third + t * third // size, k * third + (t + 1) * third // size)
                for k in range(3)]
    return [(t * n // size, (t + 1) * n // size)]
