"""Weight bridge from the JAX package's parameter tree to the port.

``state_dict_from_flax`` is the jax-free counterpart of
maskdit_tpu/utils/port.py::export_maskdit, with the same layout rules:

  Dense kernel (in, out)          -> Linear weight (out, in)   [transpose]
  PatchEmbed kernel (p, p, C, D)  -> conv weight (D, C, p, p)  [permute 3,2,0,1]

and the reference's key names (``model.blocks.{i}.attn.qkv.weight``, ...),
which are the port's module names. So ``EDMPrecond.load_state_dict`` takes
a bridged JAX tree and a released ``.pt`` file's ``ema`` dict alike.
``optimizer_state_from_flax`` carries optax's Adam state across the same
way: its moments have the params' tree and layout.

The evaluation path's frozen networks are bridged the same way:
``vae_state_dict_from_flax`` is the jax-free twin of ``export_vae`` (the
released ``autoencoder_kl.pth`` layout) and ``inception_state_dict_from_flax``
the inverse of ``convert_inception`` (the ``pt_inception-2015-12-05``
layout); conv kernels go (kh, kw, I, O) -> (O, I, kh, kw). ``load_vae`` and
``load_inception`` read such files into the port's modules, strictly.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX EDMPrecond param tree (nested dicts of arrays) -> the port's
    state dict, as fp32 torch tensors on the CPU."""
    state: dict[str, np.ndarray] = {}
    m = params["model"]

    def lin(key: str, node: Mapping) -> None:
        state[key + ".weight"] = np.asarray(node["kernel"]).T
        if "bias" in node:
            state[key + ".bias"] = np.asarray(node["bias"])

    state["model.x_embedder.proj.weight"] = np.asarray(
        m["x_embedder"]["kernel"]
    ).transpose(3, 2, 0, 1)
    state["model.x_embedder.proj.bias"] = np.asarray(m["x_embedder"]["bias"])
    lin("model.t_embedder.mlp.0", m["t_embedder"]["fc1"])
    lin("model.t_embedder.mlp.2", m["t_embedder"]["fc2"])
    if "y_embedder" in m:
        lin("model.y_embedder.embedding_table", m["y_embedder"]["embedding_table"])
    for group in ("blocks", "decoder_blocks"):
        i = 0
        while f"{group}_{i}" in m:
            b = m[f"{group}_{i}"]
            lin(f"model.{group}.{i}.attn.qkv", b["attn"]["qkv"])
            lin(f"model.{group}.{i}.attn.proj", b["attn"]["proj"])
            lin(f"model.{group}.{i}.mlp.fc1", b["mlp"]["fc1"])
            lin(f"model.{group}.{i}.mlp.fc2", b["mlp"]["fc2"])
            lin(f"model.{group}.{i}.adaLN_modulation.1", b["adaLN_modulation"])
            i += 1
    for layer in ("decoder_layer", "final_layer"):
        if layer in m:
            lin(f"model.{layer}.adaLN_modulation.1", m[layer]["adaLN_modulation"])
            lin(f"model.{layer}.linear", m[layer]["linear"])
    for emb in ("feat_embedder", "cls_token_embedder", "enc_feat_embedder"):
        if emb in m:
            lin(f"model.{emb}", m[emb])
    for tok in ("mask_token", "cls_token"):
        if tok in m:
            state[f"model.{tok}"] = np.asarray(m[tok])
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
        for k, v in state.items()
    }


def optimizer_state_from_flax(adam_state: Any) -> dict[str, Any]:
    """An optax ``ScaleByAdamState`` (count, mu, nu) -> the port's Adam
    state ``{'count': int, 'mu': state dict, 'nu': state dict}``, the
    ``opt`` entry of a training checkpoint (``TrainState.load_opt_state``).
    Dense moments are transposed as their kernels are; values are fp32."""
    return {
        "count": int(np.asarray(adam_state.count)),
        "mu": state_dict_from_flax(adam_state.mu),
        "nu": state_dict_from_flax(adam_state.nu),
    }


def _torch_state(state: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in state.items()}


def _conv_weight(kernel: Any) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _vae_key(path: list[str]) -> str:
    """A flax AutoencoderKL path -> the released key prefix, e.g.
    encoder/down_0_block_1/conv1/conv -> encoder.down.0.block.1.conv1 and
    decoder/up_2_upsample/conv/conv -> decoder.up.2.upsample.conv."""
    parts: list[str] = []
    for p in path:
        if p == "conv" and parts:  # the inner nn.Conv of the JAX Conv wrapper
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_block_(\d+)", p)
        if m:
            parts += [m.group(1), m.group(2), "block", m.group(3)]
            continue
        m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", p)
        if m:
            parts += [m.group(1), m.group(2), m.group(3), "conv"]
            continue
        m = re.fullmatch(r"mid_(block_1|block_2|attn_1)", p)
        parts += ["mid", m.group(1)] if m else [p]
    return ".".join(parts)


def vae_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX AutoencoderKL param tree -> the port's ``AutoencoderKL``
    state dict (the released ``autoencoder_kl.pth`` keys), fp32 on the CPU."""
    state: dict[str, np.ndarray] = {}

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            if not isinstance(v, Mapping):
                raise KeyError(f"unexpected VAE leaf {'/'.join(path + [k])}")
            key = _vae_key(path + [k])
            if "kernel" in v:  # a conv
                state[key + ".weight"] = _conv_weight(v["kernel"])
                state[key + ".bias"] = np.asarray(v["bias"])
            elif "scale" in v:  # a GroupNorm
                state[key + ".weight"] = np.asarray(v["scale"])
                state[key + ".bias"] = np.asarray(v["bias"])
            else:
                walk(v, path + [k])

    walk(params, [])
    return _torch_state(state)


def inception_state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX InceptionV3 param tree -> the port's detector state dict (the
    ``pt_inception-2015-12-05`` keys): each BasicConv's kernel under
    ``<path>.conv.weight`` and its frozen batch norm under ``<path>.bn.{weight,
    bias,running_mean,running_var,num_batches_tracked}``; ``fc`` transposed."""
    state: dict[str, np.ndarray] = {
        "fc.weight": np.asarray(params["fc"]["kernel"]).T,
        "fc.bias": np.asarray(params["fc"]["bias"]),
    }
    counts: list[str] = []

    def walk(node: Mapping, path: list[str]) -> None:
        for k, v in node.items():
            prefix = ".".join(path + [k])
            if "scale" in v:  # a BasicConv
                state[f"{prefix}.conv.weight"] = _conv_weight(v["conv"]["kernel"])
                for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                                     ("running_mean", "mean"), ("running_var", "var")):
                    state[f"{prefix}.bn.{ours}"] = np.asarray(v[theirs])
                counts.append(f"{prefix}.bn.num_batches_tracked")
            else:
                walk(v, path + [k])

    walk({k: v for k, v in params.items() if k != "fc"}, [])
    out = _torch_state(state)
    out.update({key: torch.tensor(0, dtype=torch.long) for key in counts})
    return out


def load_vae(path: str, vae: Optional[torch.nn.Module] = None) -> torch.nn.Module:
    """The port's AutoencoderKL (full SD config, or the module ``vae``) from
    an ``autoencoder_kl.pth`` file, loaded strictly, on the CPU, in eval
    mode."""
    from maskdit_tpu_torch.models.vae import AutoencoderKL

    vae = AutoencoderKL() if vae is None else vae
    vae.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return vae.eval().requires_grad_(False)


def load_inception(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a ``pt_inception-2015-12-05`` file, checked by a
    strict load into the port's InceptionV3."""
    from maskdit_tpu_torch.evals.inception import InceptionV3

    state = torch.load(path, map_location="cpu", weights_only=True)
    InceptionV3().load_state_dict(state, strict=True)
    return state


# -- the mesh's shards of a state dict (parallel/mesh.py's rules) -------------------

def leaf_split(name: str, shape, spec: tuple, mesh_shape: dict) -> tuple:
    """How ``parallel.mesh``'s fitted ``spec`` splits a leaf of the full
    ``shape``: (tensor dim or None, fsdp dim or None). Only 1-d and 2-d
    leaves are split by the rules."""
    from maskdit_tpu_torch.parallel.mesh import fit_spec

    fitted = fit_spec(spec, tuple(shape), mesh_shape)
    dim = lambda axis: fitted.index(axis) if axis in fitted else None
    return dim("tensor"), dim("fsdp")


def shard_leaf(name: str, full: torch.Tensor, spec: tuple, mesh_shape: dict,
               coords: dict) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` holds: its tensor
    rank's rows or columns (``parallel.mesh.tensor_runs``: qkv by whole
    heads), then its fsdp rank's contiguous chunk of the fsdp dim."""
    from maskdit_tpu_torch.parallel.mesh import tensor_runs

    dim_t, dim_f = leaf_split(name, full.shape, spec, mesh_shape)
    out = full
    if dim_t is not None:
        runs = tensor_runs(name, full.shape[dim_t], coords["tensor"], mesh_shape["tensor"])
        out = torch.cat([out.narrow(dim_t, a, b - a) for a, b in runs], dim_t)
    if dim_f is not None:
        n = out.shape[dim_f] // mesh_shape["fsdp"]
        out = out.narrow(dim_f, coords["fsdp"] * n, n)
    return out.contiguous()


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh_shape: dict, coords: dict,
                     rules: Optional[list] = None) -> dict[str, torch.Tensor]:
    """A full port state dict -> the shards of the rank at ``coords`` of a
    mesh of ``mesh_shape`` ({data, fsdp, tensor}), by the mesh's rules."""
    from maskdit_tpu_torch.parallel.mesh import param_specs

    specs = param_specs(list(full), rules)
    return {k: shard_leaf(k, v, specs[k], mesh_shape, coords) for k, v in full.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]], mesh_shape: dict,
                      shapes: Mapping[str, Any], rules: Optional[list] = None
                      ) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: every rank's shards (in rank
    order, ``parallel.mesh.coords_of``) and the full ``shapes`` -> the full
    state dict, bit for bit."""
    from maskdit_tpu_torch.parallel.mesh import coords_of, param_specs, tensor_runs

    specs = param_specs(list(shapes), rules)
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        dim_t, dim_f = leaf_split(name, shape, specs[name], mesh_shape)
        first = shards[0][name]
        full = torch.empty(shape, dtype=first.dtype, device=first.device)
        for rank, piece in enumerate(shards):
            c = coords_of(rank, mesh_shape)
            if c["data"]:
                continue  # data replicas hold the same values
            view_pairs = [(full, piece[name])]
            if dim_t is not None:
                runs = tensor_runs(name, shape[dim_t], c["tensor"], mesh_shape["tensor"])
                pairs, lo = [], 0
                for a, b in runs:
                    pairs.append((full.narrow(dim_t, a, b - a),
                                  piece[name].narrow(dim_t, lo, b - a)))
                    lo += b - a
                view_pairs = pairs
            for dst, src in view_pairs:
                if dim_f is not None:
                    n = src.shape[dim_f]
                    dst = dst.narrow(dim_f, c["fsdp"] * n, n)
                dst.copy_(src)
        out[name] = full
    return out
