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
"""

from __future__ import annotations

from typing import Any, Mapping

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
