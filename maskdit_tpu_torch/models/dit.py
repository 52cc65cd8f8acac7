"""MaskDiT: asymmetric masked diffusion transformer (encoder + light decoder).

Counterpart of maskdit_tpu/models/dit.py (reference models/maskdit.py:
237-587): patch, timestep and label embeddings, the encoder blocks, then
(with ``use_decoder``) the DecoderLayer, the decoder blocks at the fixed
8 x 512 x 16 width, and the FinalLayer. In training with a mask ratio the
encoder runs on the kept tokens only and the decoder on all of them, the
dropped ones filled with the mask token (models/masking.py). The JAX
package's pad-to-max masking, ``ScannedBlocks`` and remat policies are not
ported; the last two exist only to cut XLA compile time.

API as in the JAX package: ``model(x, t, y)`` returns a dict whose 'x' is
(N, out_channels, H, W).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from maskdit_tpu_torch.models import masking
from maskdit_tpu_torch.models.layers import (
    DecoderLayer,
    DiTBlock,
    FinalLayer,
    LabelEmbedder,
    PatchEmbed,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
)

DECODER_HIDDEN_SIZE = 512  # reference: maskdit.py:310
DECODER_DEPTH = 8  # reference: maskdit.py:311
DECODER_NUM_HEADS = 16  # reference: maskdit.py:312


class MaskDiT(nn.Module):
    """Diffusion transformer with masked-token training.

    Argument defaults mirror DiT.__init__ (reference: maskdit.py:242-261).
    The DECODER_* constants are read at construction, as the JAX version
    reads them in ``setup``. ``use_flash`` goes to every encoder and
    decoder block's ``Attention`` (None = auto, True = ops/flash.py's
    kernels, False = the plain path).
    """

    def __init__(
        self,
        input_size: int = 32,
        patch_size: int = 2,
        in_channels: int = 4,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        num_classes: int = 1000,
        learn_sigma: bool = False,
        use_decoder: bool = False,
        mae_loss_coef: float = 0.0,
        dtype: torch.dtype = torch.bfloat16,
        use_flash: Optional[bool] = None,
    ):
        super().__init__()
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.num_classes = num_classes
        self.use_decoder = use_decoder
        self.mae_loss_coef = mae_loss_coef
        self.dtype = dtype
        grid = input_size // patch_size

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        if num_classes:
            self.y_embedder = LabelEmbedder(num_classes, hidden_size, dtype=dtype)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(get_2d_sincos_pos_embed(hidden_size, grid))[None],
            persistent=False,
        )
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, hidden_size, num_heads, mlp_ratio, dtype=dtype,
                     use_flash=use_flash)
            for _ in range(depth)
        )
        final_hidden_size = hidden_size
        if use_decoder:
            self.decoder_layer = DecoderLayer(hidden_size, DECODER_HIDDEN_SIZE, dtype=dtype)
            self.register_buffer(
                "decoder_pos_embed",
                torch.from_numpy(get_2d_sincos_pos_embed(DECODER_HIDDEN_SIZE, grid))[None],
                persistent=False,
            )
            self.decoder_blocks = nn.ModuleList(
                DiTBlock(DECODER_HIDDEN_SIZE, hidden_size, DECODER_NUM_HEADS,
                         mlp_ratio, dtype=dtype, use_flash=use_flash)
                for _ in range(DECODER_DEPTH)
            )
            if mae_loss_coef > 0:
                # learned mask token exists only with the MAE aux loss
                # (reference: maskdit.py:323-324); the unmasked forward
                # does not read it
                self.mask_token = nn.Parameter(
                    torch.empty(1, 1, DECODER_HIDDEN_SIZE).normal_(std=0.02)
                )
            final_hidden_size = DECODER_HIDDEN_SIZE
        self.final_layer = FinalLayer(
            final_hidden_size, hidden_size, patch_size, self.out_channels, dtype=dtype
        )

    def _condition(self, t: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        """c = t_emb + y_emb (reference: maskdit.py:491-504)."""
        c = self.t_embedder(t)
        if self.num_classes and y is not None:
            c = c + self.y_embedder(y)
        return c

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
        mask_ratio: float = 0.0, mask_info: Optional[masking.MaskInfo] = None,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Full forward (reference: DiT.forward, maskdit.py:511-557).

        With ``mask_ratio > 0`` a mask is drawn from ``generator`` unless
        ``mask_info`` is given, and returned as ``out['mask']``; only with
        ``train`` does it drop tokens (at inference it is ignored, as in
        the reference, maskdit.py:479-483).
        """
        x_tok = self.x_embedder(x) + self.pos_embed.to(self.dtype)
        masked = mask_ratio > 0
        if masked and mask_info is None:
            mask_info = masking.random_mask(
                x_tok.shape[0], x_tok.shape[1], mask_ratio, generator, device=x.device
            )
        if masked and train:
            x_tok = masking.gather_tokens(x_tok, mask_info.ids_keep)
        c = self._condition(t, y)
        for block in self.blocks:
            x_tok = block(x_tok, c)
        out = {"mask": mask_info.mask} if masked else {}
        if self.use_decoder:
            x_tok = self.decoder_layer(x_tok, c)
            if masked and train:
                # the learned token exists only with the MAE loss; zeros
                # otherwise (JAX dit.py:383-387)
                mask_token = (
                    self.mask_token if self.mae_loss_coef > 0
                    else x_tok.new_zeros((1, 1, x_tok.shape[2]))
                )
                x_tok = masking.scatter_tokens(x_tok, mask_info.ids_restore, mask_token)
            x_tok = x_tok + self.decoder_pos_embed.to(self.dtype)
            for block in self.decoder_blocks:
                x_tok = block(x_tok, c)
        x_tok = self.final_layer(x_tok, c)
        if not self.use_decoder and masked and train:
            zero_tok = x_tok.new_zeros((1, 1, x_tok.shape[2]))
            x_tok = masking.scatter_tokens(x_tok, mask_info.ids_restore, zero_tok)
        out["x"] = self.unpatchify(x_tok)
        return out

    def forward_with_cfg(
        self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, cfg_scale: float,
    ) -> dict:
        """CFG double-batch forward (reference: maskdit.py:559-587).

        The conditional half uses y, the unconditional half the zero label
        vector (the null class of the Linear-on-one-hot embedder). Guidance
        applies to the first in_channels channels only, as the reference
        does (maskdit.py:578-581).
        """
        combined = torch.cat([x, x], dim=0)
        y_full = torch.cat([y, torch.zeros_like(y)], dim=0)
        t_full = torch.cat([t, t], dim=0) if t.shape[0] == x.shape[0] else t
        model_out = self(combined, t_full, y_full, train=False)["x"]
        eps, rest = model_out[:, : self.in_channels], model_out[:, self.in_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        half_rest = rest[: rest.shape[0] // 2]
        return {"x": torch.cat([half_eps, half_rest], dim=1)}

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(N, L, p*p*C) -> (N, C, H, W) (reference: maskdit.py:411-424)."""
        c = self.out_channels
        p = self.patch_size
        n, l, _ = x.shape
        h = w = int(round(l ** 0.5))
        if h * w != l:
            raise ValueError(f"token count {l} is not a square")
        x = x.reshape(n, h, w, p, p, c)
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(n, c, h * p, w * p)


# -- model registry (reference: maskdit.py:649-715) --------------------------

DIT_CONFIGS = {
    "DiT-H/2": dict(depth=32, hidden_size=1280, patch_size=2, num_heads=16),
    "DiT-H/4": dict(depth=32, hidden_size=1280, patch_size=4, num_heads=16),
    "DiT-H/8": dict(depth=32, hidden_size=1280, patch_size=8, num_heads=16),
    "DiT-XL/2": dict(depth=28, hidden_size=1152, patch_size=2, num_heads=16),
    "DiT-XL/4": dict(depth=28, hidden_size=1152, patch_size=4, num_heads=16),
    "DiT-XL/8": dict(depth=28, hidden_size=1152, patch_size=8, num_heads=16),
    "DiT-L/2": dict(depth=24, hidden_size=1024, patch_size=2, num_heads=16),
    "DiT-L/4": dict(depth=24, hidden_size=1024, patch_size=4, num_heads=16),
    "DiT-L/8": dict(depth=24, hidden_size=1024, patch_size=8, num_heads=16),
    "DiT-B/2": dict(depth=12, hidden_size=768, patch_size=2, num_heads=12),
    "DiT-B/4": dict(depth=12, hidden_size=768, patch_size=4, num_heads=12),
    "DiT-B/8": dict(depth=12, hidden_size=768, patch_size=8, num_heads=12),
    "DiT-S/2": dict(depth=12, hidden_size=384, patch_size=2, num_heads=6),
    "DiT-S/4": dict(depth=12, hidden_size=384, patch_size=4, num_heads=6),
    "DiT-S/8": dict(depth=12, hidden_size=384, patch_size=8, num_heads=6),
}


def create_dit(model_type: str, **kwargs) -> MaskDiT:
    """Build a MaskDiT from a registry name (reference: DiT_models)."""
    if model_type not in DIT_CONFIGS:
        raise KeyError(
            f"unknown model type '{model_type}' (known: {sorted(DIT_CONFIGS)})"
        )
    cfg = dict(DIT_CONFIGS[model_type])
    cfg.update(kwargs)
    return MaskDiT(**cfg)
