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
from typing import Any, Mapping, Optional

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
