"""Frozen Stable-Diffusion VAE (AutoencoderKL f=8, z=4ch), NCHW.

Counterpart of maskdit_tpu/models/vae.py (the reference's
FrozenAutoencoderKL, autoencoder.py:412-479): GroupNorm + swish ResNet conv
stacks with one single-head attention block at the bottleneck (ddconfig:
ch 128, ch_mult 1/2/4/4, 2 res blocks, no attention resolutions, double_z).
Module names give ``state_dict()`` the keys of the released
``autoencoder_kl.pth`` (``encoder.down.0.block.1.norm1.weight``,
``decoder.up.3.upsample.conv.weight``, ``decoder.mid.attn_1.q.weight``,
``quant_conv.weight``, ...), so that file loads with ``strict=True``.

Public API, NCHW in and out, scale factor 0.18215:
  encode_moments(x) -> (N, 8, H/8, W/8)
  sample_z(moments, noise or generator) -> z * scale_factor
  encode(x, generator) -> z
  decode(z) -> (N, 3, 8h, 8w) in about [-1, 1]

Everything runs in fp32 with TF32 off inside ``encode_moments`` and
``decode`` (``utils.precision.exact_fp32``), as the JAX package computes in
fp32. The convolutions are cuDNN's; the mid-block attention (one head of
width C = 512 over H·W tokens) is a plain matmul and an fp32 softmax, as
the JAX package writes it with einsums outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from maskdit_tpu_torch.utils.precision import exact_fp32


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6, affine), statistics in fp32."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    """norm-swish-conv twice, a learned 1x1 shortcut where the channel count
    changes (reference: autoencoder.py:80-135, no time embedding)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm32(cin)
        self.conv1 = conv3x3(cin, cout)
        self.norm2 = GroupNorm32(cout)
        self.conv2 = conv3x3(cout, cout)
        self.nin_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """One head over the H·W spatial tokens, width C, softmax in fp32
    (reference: autoencoder.py:148-199)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        h_ = self.norm(x)
        q = self.q(h_).reshape(n, c, h * w).transpose(1, 2)  # (n, hw, c)
        k = self.k(h_).reshape(n, c, h * w)
        v = self.v(h_).reshape(n, c, h * w)
        attn = torch.softmax((torch.matmul(q, k) * c ** -0.5).float(), dim=-1).to(v.dtype)
        out = torch.matmul(v, attn.transpose(1, 2)).reshape(n, c, h, w)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """A stride-2 3x3 conv after torch's asymmetric (0, 1, 0, 1) padding
    (reference: autoencoder.py:57-76)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (reference: autoencoder.py:38-54)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _mid(channels: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels)
    mid.attn_1 = AttnBlock(channels)
    mid.block_2 = ResnetBlock(channels, channels)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, z_channels: int = 4,
                 double_z: bool = True):
        super().__init__()
        self.conv_in = conv3x3(in_channels, ch)
        self.down = nn.ModuleList()
        cin = ch
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(cin, ch * mult))
                cin = ch * mult
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(cin)
            self.down.append(level)
        self.mid = _mid(cin)
        self.norm_out = GroupNorm32(cin)
        self.conv_out = conv3x3(cin, 2 * z_channels if double_z else z_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4):
        super().__init__()
        cin = ch * ch_mult[-1]
        self.conv_in = conv3x3(z_channels, cin)
        self.mid = _mid(cin)
        # up[i] is level i (the reference inserts each level at the front)
        self.up = nn.ModuleList([nn.Module() for _ in ch_mult])
        for i in reversed(range(len(ch_mult))):
            level = self.up[i]
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(cin, ch * ch_mult[i]))
                cin = ch * ch_mult[i]
            if i != 0:
                level.upsample = Upsample(cin)
        self.norm_out = GroupNorm32(cin)
        self.conv_out = conv3x3(cin, out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid, self.conv_in(z))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """The frozen KL autoencoder (reference: autoencoder.py:412-479)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, embed_dim: int = 4, z_channels: int = 4,
                 scale_factor: float = 0.18215):
        super().__init__()
        self.scale_factor = scale_factor
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels=z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels=z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    @torch.no_grad()
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        with exact_fp32():
            return self.quant_conv(self.encoder(x.float()))

    def sample_z(self, moments: torch.Tensor,
                 noise: Union[torch.Tensor, torch.Generator, None] = None) -> torch.Tensor:
        """scale_factor * (mean + std * noise); ``noise`` is the standard
        normal draw itself, or the generator to draw it from."""
        mean, logvar = moments.chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        if not isinstance(noise, torch.Tensor):
            noise = torch.randn(mean.shape, generator=noise, dtype=mean.dtype,
                                device=mean.device)
        return self.scale_factor * (mean + std * noise)

    def encode(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sample_z(self.encode_moments(x), generator)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with exact_fp32():
            return self.decoder(self.post_quant_conv((1.0 / self.scale_factor) * z.float()))
