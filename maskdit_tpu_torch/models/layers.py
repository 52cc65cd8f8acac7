"""Building-block layers for the masked DiT.

Counterpart of maskdit_tpu/models/layers.py, itself a port of the
reference components in models/maskdit.py: TimestepEmbedder (:27-65),
LabelEmbedder (:68-81), DiTBlock (:170-192), DecoderLayer (:195-213),
FinalLayer (:216-234), PatchEmbed (timm) and the fixed 2D sin-cos
positional embeddings (:595-642).

Module and parameter names are the reference's, so a released ``.pt``
state dict and a JAX tree passed through ``utils.port.state_dict_from_flax``
both load with ``load_state_dict``. The adaLN 6-way modulation keeps the
reference chunk order (shift_msa, scale_msa, gate_msa, shift_mlp,
scale_mlp, gate_mlp).

Numerics, as in the JAX package: parameters are fp32; each Linear runs in
the compute dtype (input, weight and bias cast to it, as flax
``Dense(dtype=...)`` does); LayerNorm statistics and softmax are fp32.
Weights are initialised as the reference does; a checkpoint replaces them.

Tensor parallelism (the mesh's tensor axis, ``parallel/mesh.py``): given a
``TensorSplit`` of size T, a block's ``Attention`` holds H/T heads (qkv by
whole heads: rank t's q, k and v of heads [t H/T, (t+1) H/T)) and its
``Mlp`` 1/T of the hidden features; qkv and fc1 split by output features
(their biases split with them), proj and fc2 by input features
(``RowParallelLinear``), whose partial products are summed over the tensor
group (``sum_over_tensor_group``) before their biases are added, once. The
sum's conjugate, ``copy_to_tensor_group`` (identity forward, sum of the
gradient backward), sits before qkv and fc1. ``attention_route`` is asked
at the local head count, so the kernels run at H/T heads.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from maskdit_tpu_torch.ops import flash, flash_batched, flash_big
from maskdit_tpu_torch.ops.attention import mha
from maskdit_tpu_torch.ops.flash_batched import packed_attention
from maskdit_tpu_torch.ops.flash_big import packed_attention_big


class Linear(nn.Linear):
    """nn.Linear with fp32 parameters that computes in ``compute_dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


@dataclasses.dataclass(frozen=True)
class TensorSplit:
    """This rank's place on the mesh's tensor axis: its index, the axis
    size and the process group of its tensor ranks (None: the default
    group)."""

    rank: int
    size: int
    group: Any = None


def _all_reduce_fp32(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    """The fp32 sum of ``x`` over the tensor group (a new tensor)."""
    total = x.float().clone()
    dist.all_reduce(total, group=split.group)
    return total


class _SumOverTensorGroup(torch.autograd.Function):
    """Forward: the fp32 sum of the partial products over the tensor group
    (Megatron's g); backward: the gradient as it is, in the input's dtype."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.dtype = x.dtype
        return _all_reduce_fp32(x, split)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


class _CopyToTensorGroup(torch.autograd.Function):
    """Forward: the identity (every tensor rank holds the whole input);
    backward: the sum of the gradient over the tensor group (Megatron's f),
    formed in fp32 and returned in the gradient's dtype."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_fp32(grad, ctx.split).to(grad.dtype), None


def sum_over_tensor_group(x: torch.Tensor, split: TensorSplit) -> torch.Tensor:
    return _SumOverTensorGroup.apply(x, split)


def copy_to_tensor_group(x: torch.Tensor, split: Optional[TensorSplit]) -> torch.Tensor:
    if split is None or split.size == 1:
        return x
    return _CopyToTensorGroup.apply(x, split)


class RowParallelLinear(Linear):
    """A Linear whose input features are split over the tensor group: the
    partial product of this rank's features in the compute dtype, summed in
    fp32 over the group, then the bias (whole on every rank) added once and
    the sum rounded to the compute dtype."""

    def __init__(self, in_features: int, out_features: int, split: TensorSplit,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, compute_dtype=compute_dtype)
        self.split = split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        total = sum_over_tensor_group(partial, self.split)
        return (total + self.bias.to(dt).float()).to(dt)


def _parallel_linear(in_features: int, out_features: int, split: Optional[TensorSplit],
                     dtype: torch.dtype, rows: bool) -> Linear:
    """A Linear of the block, local to this tensor rank: split by output
    features (``rows``: qkv, fc1) or by input features (proj, fc2)."""
    if split is None or split.size == 1:
        return Linear(in_features, out_features, compute_dtype=dtype)
    if rows:
        return Linear(in_features, out_features // split.size, compute_dtype=dtype)
    return RowParallelLinear(in_features // split.size, out_features, split, compute_dtype=dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation; the JAX package writes this
    formula out to match exactly this torch function."""
    return F.gelu(x, approximate="tanh")


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN shift/scale application (reference: maskdit.py:19-20)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def layer_norm_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine, fp32 statistics, biased variance
    (nn.LayerNorm(elementwise_affine=False, eps=1e-6), reference :177)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embeddings in [cos | sin] order, fp32
    (reference: TimestepEmbedder.timestep_embedding, maskdit.py:41-60)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False, extra_tokens: int = 1
) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding table (numpy, fp64 internally).

    Bit-for-bit the same values as the reference
    (get_2d_sincos_pos_embed, maskdit.py:595-642).
    """
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)  # (2, H, W), w first
    grid = grid.reshape([2, 1, grid_size, grid_size])

    def emb_1d(dim: int, pos: np.ndarray) -> np.ndarray:
        assert dim % 2 == 0
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    assert embed_dim % 2 == 0
    emb = np.concatenate(
        [emb_1d(embed_dim // 2, grid[0]), emb_1d(embed_dim // 2, grid[1])], axis=1
    )
    if cls_token and extra_tokens > 0:
        emb = np.concatenate([np.zeros([extra_tokens, embed_dim]), emb], axis=0)
    return emb.astype(np.float32)


class TimestepEmbedder(nn.Module):
    """Freq embed (256-d) -> Linear -> SiLU -> Linear (reference: :27-65)."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.dtype = dtype
        self.mlp = nn.Sequential(
            Linear(frequency_embedding_size, hidden_size, compute_dtype=dtype),
            nn.SiLU(),
            Linear(hidden_size, hidden_size, compute_dtype=dtype),
        )
        for lin in (self.mlp[0], self.mlp[2]):
            nn.init.normal_(lin.weight, std=0.02)
            nn.init.zeros_(lin.bias)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t_freq = timestep_embedding(t, self.frequency_embedding_size)
        return self.mlp(t_freq.to(self.dtype))


class LabelEmbedder(nn.Module):
    """Linear (no bias) on one-hot / soft label vectors (reference: :68-81).

    A Linear on one-hot rather than an embedding table makes the CFG null
    class exactly the zero vector (y = 0 rows embed to 0).
    """

    def __init__(self, num_classes: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding_table = Linear(num_classes, hidden_size, bias=False,
                                      compute_dtype=dtype)
        nn.init.normal_(self.embedding_table.weight, std=0.02)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding_table(y)


class PatchEmbed(nn.Module):
    """Patchify + linear projection: timm PatchEmbed's stride-p conv as a
    reshape and one matmul.

    The weight keeps the conv layout (D, C, p, p) under the reference's key
    ``proj.weight``. As in the JAX version, the product takes inputs and
    weight rounded to the compute dtype, accumulates and adds the bias in
    fp32, and rounds the sum to the compute dtype.
    """

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        # the reference initialises the conv like a Linear (maskdit.py:349-352)
        nn.init.xavier_uniform_(self.proj.weight.view(embed_dim, -1))
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} not divisible by patch {p}")
        patches = x.reshape(n, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        patches = patches.reshape(n, (h // p) * (w // p), c * p * p)
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        y = F.linear(
            patches.to(self.dtype).float(), weight.to(self.dtype).float(),
            self.proj.bias.float(),  # fp32 (a bf16 copy under amp_grads)
        )
        return y.to(self.dtype)


@functools.cache
def attention_route(num_heads: int, l: int, head_dim: int, backward: bool,
                    use_flash: Optional[bool] = None, kv_valid: bool = False) -> str:
    """Which attention runs at (heads, L, head_dim): 'packed', 'big',
    'flash' or 'plain'. It depends on the shape and the flags only; the
    tensor's device picks between a kernel and its plain version. Cached:
    the model asks once per shape, not once per call.

    The JAX package's rule (layers.py:225-277, attention.py:78-91), its
    kernels' windows held to the card's shared memory:
      * ``kv_valid`` (pad-to-max masking: the layer is given a valid-key
        count): 'plain', whatever ``use_flash`` says, since no kernel takes
        the mask;
      * ``use_flash`` False: 'plain' (the JAX package's plain path);
      * ``use_flash`` True: 'flash' (ops/flash.py, kernels #5/#6) where
        ``flash.supports(L)`` holds, else 'plain', as ``flash_mha`` falls
        back; the packed kernels are never used;
      * ``use_flash`` None (auto):
        - 'packed' (ops/flash_batched.py, kernels #1/#2) where the JAX
          package takes its whole-row kernels (``flash_batched.supports``:
          its copy of the JAX window, L a multiple of 128 within the TPU's
          VMEM budget) and the kernels launch in both input types (at a
          head dim that is a multiple of 8, every L where the bf16
          forward's logits row fits); and within ``route_window``, the L
          at which the route took them before (their FMA layouts fit),
          e.g. the cos4 finetune's buckets of 144-224 kept tokens;
        - else 'big' (ops/flash_big.py, kernels #3/#4) where
          ``flash_big.supports`` holds (the JAX ``_plan`` window: the
          512-px shapes, L 1536 at hd 72, L 2048 at hd 32);
        - else, within the whole-row forward's ``route_window`` (no
          backward) where the JAX package runs no kernel: 'big', whose
          kernels take any L at a head dim that is a multiple of 8 (the
          cos4 bucket of 240 kept tokens), or, at any other head dim,
          raise;
        - else ``mha``'s auto rule: 'flash' at L >= 1024 with L % 128 == 0
          (and 'plain' past the kernel's window, L > 2048);
        - else 'plain'.
    """
    if kv_valid or use_flash is False:
        return "plain"
    if use_flash:
        return "flash" if flash.supports(l) else "plain"
    if (flash_batched.route_window(l, head_dim, backward)
            or flash_batched.supports(num_heads, l, head_dim, backward)):
        return "packed"
    if flash_big.supports(num_heads, l, head_dim):
        return "big"
    if flash_batched.route_window(l, head_dim, False):
        if flash_big.fits(l, head_dim):
            return "big"
        raise NotImplementedError(
            f"attention backward at L={l}, head_dim={head_dim}: the whole-row "
            "backward kernel's shared memory does not fit the card, and the "
            "blocked kernels need a head dim that is a multiple of 8"
        )
    if l >= 1024 and l % 128 == 0:
        return "flash" if flash.supports(l) else "plain"
    return "plain"


def attn_from_qkv(qkv: torch.Tensor, num_heads: int, use_flash: bool,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, L, 3D) -> (N, L, D) through ``ops.attention.mha``: split the
    [q | k | v] features into (N, H, L, hd) heads, attend (keys below
    ``kv_valid`` only, where given), merge the heads (maskdit_tpu
    layers.py:264-270)."""
    n, l, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    heads = qkv.reshape(n, l, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = mha(heads[0], heads[1], heads[2], use_flash=use_flash, kv_valid=kv_valid)
    return o.permute(0, 2, 1, 3).reshape(n, l, three_d // 3)


class Attention(nn.Module):
    """timm-style MHA: a qkv Linear that emits [q | k | v] along features
    (maskdit_tpu layers.py:219-223), attention by ``attention_route``,
    output projection.

    ``use_flash`` as in the JAX package: None = auto, True = ops/flash.py's
    kernels, False = the plain path. The 'flash' and 'plain' routes run
    ``attn_from_qkv``, with a gradient under ``torch.utils.checkpoint``
    as the JAX package runs it under ``jax.checkpoint`` (layers.py:277): the
    layer keeps only qkv, and the backward recomputes the forward first, so
    a 'flash' layer launches its forward kernel twice per train step and its
    backward kernel once. Given ``kv_valid`` (pad-to-max masking) the layer
    runs the plain route with the key mask, as the JAX layer does.

    With a ``TensorSplit`` of size T the layer holds ``num_heads / T`` heads
    (``num_heads`` is the model's count; ``self.num_heads`` the local one)
    and its proj sums over the tensor group."""

    def __init__(self, hidden_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, use_flash: Optional[bool] = None,
                 split: Optional[TensorSplit] = None):
        super().__init__()
        size = 1 if split is None else split.size
        if num_heads % size:
            raise ValueError(f"{num_heads} heads do not split over a tensor axis of {size}")
        self.num_heads = num_heads // size
        self.use_flash = use_flash
        self.split = split
        self.qkv = _parallel_linear(hidden_size, 3 * hidden_size, split, dtype, rows=True)
        self.proj = _parallel_linear(hidden_size, hidden_size, split, dtype, rows=False)
        for lin in (self.qkv, self.proj):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = self.qkv(copy_to_tensor_group(x, self.split))
        hd = qkv.shape[-1] // (3 * self.num_heads)
        grad = torch.is_grad_enabled() and qkv.requires_grad
        route = attention_route(self.num_heads, x.shape[1], hd, grad, self.use_flash,
                                kv_valid is not None)
        # looked up when called, so a caller may swap the plain versions in
        if route == "packed":
            out = packed_attention(qkv, self.num_heads, hd ** -0.5)
        elif route == "big":
            out = packed_attention_big(qkv, self.num_heads, hd ** -0.5)
        elif grad:
            # (attention draws no random numbers: no RNG state to restore)
            out = checkpoint(attn_from_qkv, qkv, self.num_heads, route == "flash", kv_valid,
                             use_reentrant=False, preserve_rng_state=False)
        else:
            out = attn_from_qkv(qkv, self.num_heads, route == "flash", kv_valid)
        return self.proj(out)


class Mlp(nn.Module):
    """fc1 -> GELU(tanh) -> fc2 (timm Mlp used at reference :182); with a
    ``TensorSplit`` of size T, 1/T of the hidden features and a sum over
    the tensor group after fc2."""

    def __init__(self, hidden_size: int, mlp_hidden: int,
                 dtype: torch.dtype = torch.float32, split: Optional[TensorSplit] = None):
        super().__init__()
        size = 1 if split is None else split.size
        if mlp_hidden % size:
            raise ValueError(f"{mlp_hidden} MLP features do not split over a tensor axis of "
                             f"{size}")
        self.split = split
        self.fc1 = _parallel_linear(hidden_size, mlp_hidden, split, dtype, rows=True)
        self.fc2 = _parallel_linear(mlp_hidden, hidden_size, split, dtype, rows=False)
        for lin in (self.fc1, self.fc2):
            nn.init.xavier_uniform_(lin.weight)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(copy_to_tensor_group(x, self.split))))


def _ada_ln(c_emb_size: int, out: int, dtype: torch.dtype) -> nn.Sequential:
    """SiLU -> Linear, zero-initialised (adaLN-Zero, reference :374-383)."""
    lin = Linear(c_emb_size, out, compute_dtype=dtype)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return nn.Sequential(nn.SiLU(), lin)


class DiTBlock(nn.Module):
    """Pre-LN transformer block with adaLN-Zero conditioning
    (reference: models/maskdit.py:170-192)."""

    def __init__(self, hidden_size: int, c_emb_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 use_flash: Optional[bool] = None, split: Optional[TensorSplit] = None):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads, dtype=dtype, use_flash=use_flash,
                              split=split)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype=dtype, split=split)
        self.adaLN_modulation = _ada_ln(c_emb_size, 6 * hidden_size, dtype)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        (shift_msa, scale_msa, gate_msa,
         shift_mlp, scale_mlp, gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        h = modulate(layer_norm_no_affine(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None, :] * self.attn(h, kv_valid)
        h = modulate(layer_norm_no_affine(x), shift_mlp, scale_mlp)
        return x + gate_mlp[:, None, :] * self.mlp(h)


class DecoderLayer(nn.Module):
    """Encoder -> decoder projection: adaLN (2-way) + Linear hidden ->
    decoder hidden (reference: models/maskdit.py:195-213)."""

    def __init__(self, hidden_size: int, decoder_hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = _ada_ln(hidden_size, 2 * hidden_size, dtype)
        self.linear = Linear(hidden_size, decoder_hidden_size, compute_dtype=dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm_no_affine(x), shift, scale))


class FinalLayer(nn.Module):
    """adaLN (2-way) + Linear -> patch^2 * out_channels
    (reference: :216-234)."""

    def __init__(self, final_hidden_size: int, c_emb_size: int, patch_size: int,
                 out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.adaLN_modulation = _ada_ln(c_emb_size, 2 * final_hidden_size, dtype)
        self.linear = Linear(final_hidden_size, patch_size * patch_size * out_channels,
                             compute_dtype=dtype)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm_no_affine(x), shift, scale))
