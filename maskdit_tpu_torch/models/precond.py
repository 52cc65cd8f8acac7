"""EDM preconditioning wrapper around MaskDiT.

Counterpart of maskdit_tpu/models/precond.py (reference: EDMPrecond,
models/maskdit.py:722-781; Karras et al., "Elucidating the Design Space of
Diffusion-Based Generative Models"):

    c_skip  = sigma_d^2 / (sigma^2 + sigma_d^2)
    c_out   = sigma * sigma_d / sqrt(sigma^2 + sigma_d^2)
    c_in    = 1 / sqrt(sigma_d^2 + sigma^2)
    c_noise = log(sigma) / 4
    D_x     = c_skip * x + c_out * F_x(c_in * x, c_noise, y)

The preconditioning algebra runs in fp32; only the inner network runs in
the model's compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from maskdit_tpu_torch.models.dit import MaskDiT, create_dit
from maskdit_tpu_torch.models.masking import MaskInfo


class EDMPrecond(nn.Module):
    def __init__(
        self,
        img_resolution: int,
        img_channels: int,
        num_classes: int = 0,
        sigma_min: float = 0.0,
        sigma_max: float = float("inf"),
        sigma_data: float = 0.5,
        model_type: str = "DiT-B/2",
        use_decoder: bool = False,
        mae_loss_coef: float = 0.0,
        pad_cls_token: bool = False,
        ext_feature_dim: int = 0,
        use_encoder_feat: bool = False,
        learn_sigma: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        use_flash: Optional[bool] = None,
        tensor_split=None,
    ):
        super().__init__()
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.num_classes = num_classes
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.sigma_data = sigma_data
        self.model: MaskDiT = create_dit(
            model_type,
            input_size=img_resolution,
            in_channels=img_channels,
            num_classes=num_classes,
            use_decoder=use_decoder,
            mae_loss_coef=mae_loss_coef,
            pad_cls_token=pad_cls_token,
            ext_feature_dim=ext_feature_dim,
            use_encoder_feat=use_encoder_feat,
            learn_sigma=learn_sigma,
            dtype=dtype,
            use_flash=use_flash,
            tensor_split=tensor_split,
        )

    def _coerce_labels(self, x: torch.Tensor, class_labels) -> Optional[torch.Tensor]:
        """None + conditional model -> zero label rows (reference: :760-762)."""
        if self.num_classes == 0:
            return None
        if class_labels is None:
            return torch.zeros((x.shape[0], self.num_classes), device=x.device)
        return class_labels.reshape(-1, self.num_classes).float()

    @staticmethod
    def _coeffs(sigma: torch.Tensor, sigma_data: float):
        sigma = sigma.float().reshape(-1, 1, 1, 1)
        c_skip = sigma_data ** 2 / (sigma ** 2 + sigma_data ** 2)
        c_out = sigma * sigma_data * torch.rsqrt(sigma ** 2 + sigma_data ** 2)
        c_in = torch.rsqrt(sigma_data ** 2 + sigma ** 2)
        c_noise = torch.log(sigma) / 4.0
        return sigma, c_skip, c_out, c_in, c_noise

    def forward(
        self, x: torch.Tensor, sigma: torch.Tensor, class_labels=None,
        cfg_scale: Optional[float] = None, mask_ratio: float = 0.0,
        mask_info: Optional[MaskInfo] = None, train: bool = False,
        generator: Optional[torch.Generator] = None, feat: Optional[torch.Tensor] = None,
    ) -> dict:
        """Denoiser forward D(x; sigma) (reference: maskdit.py:756-773).

        ``mask_ratio``, ``mask_info``, ``generator`` and ``feat`` (the
        external or encoder feature) go to the model; with a mask ratio the
        result carries the model's ``mask``.
        """
        x = x.float()
        y = self._coerce_labels(x, class_labels)
        sigma, c_skip, c_out, c_in, c_noise = self._coeffs(sigma, self.sigma_data)
        x_in = c_in * x
        if cfg_scale is None:
            model_out = self.model(
                x_in, c_noise.reshape(-1), y, mask_ratio=mask_ratio,
                mask_info=mask_info, train=train, generator=generator, feat=feat,
            )
        else:
            model_out = self.model.forward_with_cfg(
                x_in, c_noise.reshape(-1), y, cfg_scale, feat=feat
            )
        f_x = model_out["x"].float()
        model_out["x"] = c_skip * x + c_out * f_x
        return model_out

    def encode(self, x: torch.Tensor, sigma: torch.Tensor, class_labels=None,
               **model_kwargs) -> torch.Tensor:
        """The pooled encoder feature at noise level sigma (reference:
        maskdit.py:743-754); ``model_kwargs`` go to ``MaskDiT.encode``."""
        x = x.float()
        y = self._coerce_labels(x, class_labels)
        _, _, _, c_in, c_noise = self._coeffs(sigma, self.sigma_data)
        feat, _ = self.model.encode(c_in * x, c_noise.reshape(-1), y, **model_kwargs)
        return feat

    @staticmethod
    def round_sigma(sigma):
        """Identity: EDM's noise levels are continuous (reference :777)."""
        return sigma


PRECOND_MODELS = {"edm": EDMPrecond}


def create_model(
    precond: str = "edm",
    img_resolution: int = 32,
    img_channels: int = 4,
    **kwargs,
) -> EDMPrecond:
    """Registry entry point (reference: Precond_models, maskdit.py:779-781)."""
    if precond not in PRECOND_MODELS:
        raise KeyError(f"unknown precond '{precond}' (known: {sorted(PRECOND_MODELS)})")
    return PRECOND_MODELS[precond](
        img_resolution=img_resolution, img_channels=img_channels, **kwargs
    )
