"""MaskDiT: asymmetric masked diffusion transformer (encoder + light decoder).

Counterpart of maskdit_tpu/models/dit.py (reference models/maskdit.py:
237-587): patch, timestep and label embeddings, the encoder blocks, then
(with ``use_decoder``) the DecoderLayer, the decoder blocks at the fixed
8 x 512 x 16 width, and the FinalLayer. In training with a mask ratio the
encoder runs on the kept tokens only and the decoder on all of them, the
dropped ones filled with the mask token (models/masking.py). A pad-to-max
``MaskInfo`` (``len_keep`` set) runs the encoder at ``len_max`` tokens
with attention limited to the first ``len_keep`` keys and scatters only
those back. The model corners (a class token, external features,
self-conditioning on the pooled encoder feature) are ``MaskDiT``'s
options. The JAX package's ``ScannedBlocks`` and remat policies are not
ported: they exist only to cut XLA compile time.

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
    Linear,
    PatchEmbed,
    TensorSplit,
    TimestepEmbedder,
    get_2d_sincos_pos_embed,
    layer_norm_no_affine,
)

DECODER_HIDDEN_SIZE = 512  # reference: maskdit.py:310
DECODER_DEPTH = 8  # reference: maskdit.py:311
DECODER_NUM_HEADS = 16  # reference: maskdit.py:312


def _embedder(in_features: int, out_features: int, dtype: torch.dtype) -> Linear:
    """A Linear of the conditioning (feat_embedder, cls_token_embedder,
    enc_feat_embedder): weight ~ N(0, 0.02^2), zero bias, as the JAX
    ``nn.Dense(kernel_init=normal_002)``."""
    lin = Linear(in_features, out_features, compute_dtype=dtype)
    nn.init.normal_(lin.weight, std=0.02)
    nn.init.zeros_(lin.bias)
    return lin


class MaskDiT(nn.Module):
    """Diffusion transformer with masked-token training.

    Argument defaults mirror DiT.__init__ (reference: maskdit.py:242-261).
    The DECODER_* constants are read at construction, as the JAX version
    reads them in ``setup``. ``use_flash`` goes to every encoder and
    decoder block's ``Attention`` (None = auto, True = ops/flash.py's
    kernels, False = the plain path).

    The model corners (JAX dit.py:116-119, reference maskdit.py:285-330):
    ``pad_cls_token`` puts a learned class token (``cls_token``) in front of
    the encoder's tokens, so the encoder runs at one more token; with the
    decoder its normalised output conditions the decoder through
    ``cls_token_embedder``, and it enters the decoder's tokens only with
    ``direct_cls_token`` (``decoder_extras``). ``ext_feature_dim > 0`` adds
    ``feat_embedder(feat)`` to the conditioning; ``use_encoder_feat`` (with
    the decoder) conditions on the pooled encoder feature of ``encode``
    through ``enc_feat_embedder``, computed first at inference when no
    ``feat`` is given.

    ``tensor_split`` (a ``layers.TensorSplit``) builds the model of one rank
    of the mesh's tensor axis: every encoder and decoder block at its local
    heads and MLP width (``parallel/mesh.py``); the other layers whole.
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
        pad_cls_token: bool = False,
        direct_cls_token: bool = False,
        ext_feature_dim: int = 0,
        use_encoder_feat: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        use_flash: Optional[bool] = None,
        tensor_split: Optional[TensorSplit] = None,
    ):
        super().__init__()
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.hidden_size = hidden_size
        self.num_classes = num_classes
        self.use_decoder = use_decoder
        self.mae_loss_coef = mae_loss_coef
        self.pad_cls_token = pad_cls_token
        self.direct_cls_token = direct_cls_token
        self.ext_feature_dim = ext_feature_dim
        self.use_encoder_feat = use_encoder_feat
        self.dtype = dtype
        grid = input_size // patch_size

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        if num_classes:
            self.y_embedder = LabelEmbedder(num_classes, hidden_size, dtype=dtype)
        if pad_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, hidden_size).normal_(std=0.02))
        if ext_feature_dim > 0:
            self.feat_embedder = _embedder(ext_feature_dim, hidden_size, dtype)
        # the fixed sin-cos tables, with a zero row per leading extra token
        # (JAX dit.py:255-269)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(get_2d_sincos_pos_embed(
                hidden_size, grid, cls_token=pad_cls_token, extra_tokens=self.extras))[None],
            persistent=False,
        )
        self.blocks = nn.ModuleList(
            DiTBlock(hidden_size, hidden_size, num_heads, mlp_ratio, dtype=dtype,
                     use_flash=use_flash, split=tensor_split)
            for _ in range(depth)
        )
        final_hidden_size = hidden_size
        if use_decoder:
            self.decoder_layer = DecoderLayer(hidden_size, DECODER_HIDDEN_SIZE, dtype=dtype)
            self.register_buffer(
                "decoder_pos_embed",
                torch.from_numpy(get_2d_sincos_pos_embed(
                    DECODER_HIDDEN_SIZE, grid, cls_token=pad_cls_token,
                    extra_tokens=self.decoder_extras))[None],
                persistent=False,
            )
            self.decoder_blocks = nn.ModuleList(
                DiTBlock(DECODER_HIDDEN_SIZE, hidden_size, DECODER_NUM_HEADS,
                         mlp_ratio, dtype=dtype, use_flash=use_flash, split=tensor_split)
                for _ in range(DECODER_DEPTH)
            )
            if mae_loss_coef > 0:
                # learned mask token exists only with the MAE aux loss
                # (reference: maskdit.py:323-324); the unmasked forward
                # does not read it
                self.mask_token = nn.Parameter(
                    torch.empty(1, 1, DECODER_HIDDEN_SIZE).normal_(std=0.02)
                )
            if pad_cls_token:
                self.cls_token_embedder = _embedder(hidden_size, hidden_size, dtype)
            if use_encoder_feat:
                self.enc_feat_embedder = _embedder(hidden_size, hidden_size, dtype)
            final_hidden_size = DECODER_HIDDEN_SIZE
        self.final_layer = FinalLayer(
            final_hidden_size, hidden_size, patch_size, self.out_channels, dtype=dtype
        )

    @property
    def extras(self) -> int:
        """Leading tokens of the encoder (the class token)."""
        return 1 if self.pad_cls_token else 0

    @property
    def decoder_extras(self) -> int:
        """Leading tokens of the decoder (reference: maskdit.py:285-289,
        313-314): the class token goes on past the encoder without a
        decoder, or with ``direct_cls_token``."""
        if self.pad_cls_token and (not self.use_decoder or self.direct_cls_token):
            return 1
        return 0

    def _condition(self, t: torch.Tensor, y: Optional[torch.Tensor],
                   feat: Optional[torch.Tensor]) -> torch.Tensor:
        """c = t_emb + y_emb (+ feat_emb) (reference: maskdit.py:491-504):
        the external feature where ``ext_feature_dim > 0``, else an encoder
        feature of the model's width with ``use_encoder_feat``."""
        c = self.t_embedder(t)
        if self.num_classes and y is not None:
            c = c + self.y_embedder(y)
        if self.ext_feature_dim > 0 and feat is not None:
            c = c + self.feat_embedder(feat)
        elif (self.use_encoder_feat and self.use_decoder and feat is not None
              and feat.shape[-1] == self.hidden_size):
            c = c + self.enc_feat_embedder(feat)
        return c

    def _embed_and_mask(
        self, x: torch.Tensor, mask_ratio: float, mask_info: Optional[masking.MaskInfo],
        train: bool, generator: Optional[torch.Generator],
    ) -> tuple[torch.Tensor, Optional[masking.MaskInfo]]:
        """Patch embedding + position, the mask (drawn from ``generator``
        unless given; tokens dropped only with ``train``: at inference the
        mask is ignored, as in the reference, maskdit.py:479-483), then the
        class token in front (JAX dit.py:294-312)."""
        pos = self.pos_embed
        x_tok = self.x_embedder(x) + pos[:, self.extras:].to(self.dtype)
        if mask_ratio > 0 and mask_info is None:
            mask_info = masking.random_mask(
                x_tok.shape[0], x_tok.shape[1], mask_ratio, generator, device=x.device
            )
        if mask_ratio > 0 and train:
            x_tok = masking.gather_tokens(x_tok, mask_info.ids_keep)
        if self.pad_cls_token:
            cls = (self.cls_token + pos[:, :self.extras]).to(self.dtype)
            x_tok = torch.cat([cls.expand(x_tok.shape[0], -1, -1), x_tok], dim=1)
        return x_tok, mask_info

    def _kv_valid(self, mask_info: Optional[masking.MaskInfo], train: bool,
                  mask_ratio: float) -> Optional[torch.Tensor]:
        """Pad-to-max: the valid prefix of the encoder's tokens, the kept
        ones and the leading extras (JAX dit.py:314-322); None = all."""
        if train and mask_ratio > 0 and mask_info is not None and mask_info.len_keep is not None:
            return mask_info.len_keep + self.extras
        return None

    def encode(
        self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor],
        mask_ratio: float = 0.0, mask_info: Optional[masking.MaskInfo] = None,
        feat: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, Optional[masking.MaskInfo]]:
        """The pooled, normalised encoder feature for self-conditioning
        (reference: maskdit.py:426-464; JAX dit.py:324-342): the mean of the
        encoder's output tokens past the extras (over the valid prefix only
        under pad-to-max), then a LayerNorm without affine. The mask, where
        ``mask_ratio > 0``, drops tokens."""
        x_tok, mask_info = self._embed_and_mask(x, mask_ratio, mask_info, True, generator)
        kv_valid = self._kv_valid(mask_info, True, mask_ratio)
        c = self._condition(t, y, feat)
        for block in self.blocks:
            x_tok = block(x_tok, c, kv_valid)
        body = x_tok[:, self.extras:]
        if kv_valid is not None:
            # the padded tail carries garbage: a masked mean
            len_keep = mask_info.len_keep
            valid = (torch.arange(body.shape[1], device=body.device) < len_keep)[None, :, None]
            x_feat = (body * valid).sum(dim=1) / len_keep
        else:
            x_feat = body.mean(dim=1)
        return layer_norm_no_affine(x_feat), mask_info

    def forward_encoder(
        self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
        mask_ratio: float = 0.0, mask_info: Optional[masking.MaskInfo] = None,
        feat: Optional[torch.Tensor] = None, train: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[dict, torch.Tensor, Optional[masking.MaskInfo]]:
        """The encoder's tokens and the conditioning (reference:
        maskdit.py:467-509): ({'x': tokens}, c, mask_info)."""
        x_tok, mask_info = self._embed_and_mask(x, mask_ratio, mask_info, train, generator)
        kv_valid = self._kv_valid(mask_info, train, mask_ratio)
        c = self._condition(t, y, feat)
        for block in self.blocks:
            x_tok = block(x_tok, c, kv_valid)
        return {"x": x_tok}, c, mask_info

    def forward(
        self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None,
        mask_ratio: float = 0.0, mask_info: Optional[masking.MaskInfo] = None,
        train: bool = False, generator: Optional[torch.Generator] = None,
        feat: Optional[torch.Tensor] = None,
    ) -> dict:
        """Full forward (reference: DiT.forward, maskdit.py:511-557).

        With ``mask_ratio > 0`` a mask is drawn from ``generator`` unless
        ``mask_info`` is given, and returned as ``out['mask']``; only with
        ``train`` does it drop tokens. ``feat`` is the external feature
        (``ext_feature_dim``) or the encoder feature; at inference with
        ``use_encoder_feat`` and no ``feat``, ``encode`` computes it first.
        """
        if not train and self.use_encoder_feat and feat is None:
            feat, _ = self.encode(x, t, y)
        x_tok, c, mask_info = self.forward_encoder(
            x, t, y, mask_ratio=mask_ratio, mask_info=mask_info, feat=feat, train=train,
            generator=generator,
        )
        x_tok = x_tok["x"]
        masked = mask_ratio > 0
        out = {"mask": mask_info.mask} if masked else {}
        if self.use_decoder:
            if self.pad_cls_token:
                c = c + self.cls_token_embedder(layer_norm_no_affine(x_tok[:, 0]))
            x_tok = self.decoder_layer(x_tok[:, self.extras - self.decoder_extras:], c)
            if masked and train:
                # the learned token exists only with the MAE loss; zeros
                # otherwise (JAX dit.py:383-387)
                mask_token = (
                    self.mask_token if self.mae_loss_coef > 0
                    else x_tok.new_zeros((1, 1, x_tok.shape[2]))
                )
                x_tok = self._scatter(x_tok, mask_info, mask_token, self.decoder_extras)
            x_tok = x_tok + self.decoder_pos_embed.to(self.dtype)
            for block in self.decoder_blocks:
                x_tok = block(x_tok, c)
        x_tok = self.final_layer(x_tok, c)
        if not self.use_decoder and masked and train:
            zero_tok = x_tok.new_zeros((1, 1, x_tok.shape[2]))
            x_tok = self._scatter(x_tok, mask_info, zero_tok, self.extras)
        out["x"] = self.unpatchify(x_tok[:, self.decoder_extras:])
        return out

    @staticmethod
    def _scatter(x_tok: torch.Tensor, mask_info: masking.MaskInfo,
                 token: torch.Tensor, extras: int) -> torch.Tensor:
        """The kept tokens back to all L past the ``extras`` leading ones,
        holes filled with ``token``: the packed or the pad-to-max scatter
        (JAX dit.py:388-412)."""
        if mask_info.len_keep is not None:
            return masking.scatter_tokens_padded(x_tok, mask_info.ids_restore, token,
                                                 mask_info.len_keep, extras=extras)
        return masking.scatter_tokens(x_tok, mask_info.ids_restore, token, extras=extras)

    def forward_with_cfg(
        self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, cfg_scale: float,
        feat: Optional[torch.Tensor] = None,
    ) -> dict:
        """CFG double-batch forward (reference: maskdit.py:559-587).

        The conditional half uses y, the unconditional half the zero label
        vector (the null class of the Linear-on-one-hot embedder); ``feat``
        conditions both halves. Guidance applies to the first in_channels
        channels only, as the reference does (maskdit.py:578-581).
        """
        combined = torch.cat([x, x], dim=0)
        y_full = torch.cat([y, torch.zeros_like(y)], dim=0)
        t_full = torch.cat([t, t], dim=0) if t.shape[0] == x.shape[0] else t
        if feat is not None:
            feat = torch.cat([feat, feat], dim=0)
        model_out = self(combined, t_full, y_full, train=False, feat=feat)["x"]
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
