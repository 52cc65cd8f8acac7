"""Train state and the training step.

Counterpart of maskdit_tpu/train/state.py. One step covers the hot loop of
the reference train.py:198-287: moments -> z (utils.py:59-65), label
dropout for CFG (train.py:208-209), gradient accumulation over micro-batches
(train.py:211-227), the EDM loss, and Adam with the EMA update
(helper.py:48-58) in one fused sweep.

Numerics as in the JAX package without ``amp_grads``: parameters, Adam
moments and EMA are fp32; each Linear computes in the model's compute dtype
(bf16 by default) inside autograd, so the gradients are fp32.

Memory layout: the parameters, their gradient accumulator, the EMA and both
moments are each ONE flat fp32 buffer. The model's parameters are views
into ``params`` and their ``.grad`` views into ``grads`` (autograd adds each
micro-batch's gradient into it in place), so the fused update is a single
kernel launch over all leaves. ``TrainState.named`` gives the per-parameter
views under the state-dict keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn as nn

from maskdit_tpu_torch.models.masking import MaskInfo
from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.ops.fused_adam import AdamState, FusedAdamEma
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.schedules import lr_with_rampup

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def reparameterize_moments(
    moments: torch.Tensor, scale_factor: float = 0.18215,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """VAE moments (N, 2C, H, W) -> z (N, C, H, W) (reference: utils.py:
    59-65); ``noise`` (unit normals) replaces the draw from ``generator``."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    std = torch.exp(0.5 * logvar)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    return scale_factor * (mean + std * noise)


def make_optimizer(
    base_lr: float,
    global_batch_size: int,
    rampup_kimg: float = 0.0,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    fused: bool = True,
    moment_dtype: Optional[str] = None,
    nu_dtype: Optional[str] = None,
) -> FusedAdamEma:
    """Adam as apex FusedAdam(adam_w_mode=True, wd=0) with the kimg warmup
    (reference: train.py:141, 223-226), as the fused Adam + EMA update.

    ``moment_dtype='bfloat16'`` stores the first moment in bf16 (the math
    stays fp32). The staged optax path and weight decay are not ported:
    the released configs train with the fused update at wd 0.
    """
    if not fused:
        raise NotImplementedError("the port's optimizer is the fused Adam + EMA update")
    if weight_decay != 0.0:
        raise NotImplementedError("fused Adam + EMA implements wd=0 (the reference setting)")
    if rampup_kimg > 0:
        schedule = lambda step: lr_with_rampup(step, base_lr, global_batch_size, rampup_kimg)
    else:
        schedule = base_lr
    return FusedAdamEma(
        learning_rate=schedule, b1=betas[0], b2=betas[1], eps=eps,
        mu_dtype=_DTYPES[moment_dtype], nu_dtype=_DTYPES[nu_dtype],
    )


@dataclasses.dataclass
class TrainState:
    """The model (its parameters views into ``params``), the flat fp32
    buffers, the optimizer state and the step count."""

    step: int
    model: EDMPrecond
    params: torch.Tensor
    grads: torch.Tensor
    ema: torch.Tensor
    opt_state: AdamState
    layout: list[tuple[str, torch.Size, int]]

    def named(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-parameter views of a flat buffer, under the state-dict keys."""
        return {
            name: flat[off:off + shape.numel()].view(shape)
            for name, shape, off in self.layout
        }

    def checkpoint(self) -> dict[str, Any]:
        """``{model, ema, opt, step}`` on the CPU, in the reference ``.pt``
        layout (train.py:259-268); ``opt`` is optax's (count, mu, nu)."""
        cpu = lambda flat: {k: v.detach().cpu().clone() for k, v in self.named(flat).items()}
        return {
            "model": cpu(self.params),
            "ema": cpu(self.ema),
            "opt": {
                "count": self.opt_state.count,
                "mu": cpu(self.opt_state.mu),
                "nu": cpu(self.opt_state.nu),
            },
            "step": self.step,
        }

    def load(self, ckpt: dict[str, Any]) -> None:
        """Restore from ``checkpoint()``'s dict: every key it has is
        copied into the flat buffers (``model`` and ``ema`` alone import a
        released checkpoint)."""
        with torch.no_grad():
            for key, flat in (("model", self.params), ("ema", self.ema)):
                if key in ckpt:
                    _copy_named(self.named(flat), ckpt[key], key)
            if "opt" in ckpt:
                self.load_opt_state(ckpt["opt"])
        if "step" in ckpt:
            self.step = int(ckpt["step"])

    def load_opt_state(self, opt: dict[str, Any]) -> None:
        """Adam's count, mu and nu from ``{count, mu, nu}`` dicts keyed like
        the parameters (``utils.port.optimizer_state_from_flax``)."""
        with torch.no_grad():
            _copy_named(self.named(self.opt_state.mu), opt["mu"], "opt.mu")
            _copy_named(self.named(self.opt_state.nu), opt["nu"], "opt.nu")
        self.opt_state.count = int(opt["count"])


def _copy_named(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str) -> None:
    missing = sorted(set(dst) - set(src))
    if missing:
        raise KeyError(f"{what}: no values for {missing[:5]} ({len(missing)} keys)")
    for k, v in dst.items():
        v.copy_(src[k].reshape(v.shape))


def flatten_parameters(module: nn.Module) -> tuple[torch.Tensor, list[tuple[str, torch.Size, int]]]:
    """Move every parameter of ``module`` into one flat fp32 buffer on its
    device and make the parameters views into it. Returns the buffer and
    the (name, shape, offset) of each parameter."""
    named = list(module.named_parameters())
    device = named[0][1].device
    total = sum(p.numel() for _, p in named)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    layout, offset = [], 0
    with torch.no_grad():
        for name, p in named:
            n = p.numel()
            view = flat[offset:offset + n]
            view.copy_(p.reshape(-1))
            p.data = view.view(p.shape)
            layout.append((name, p.shape, offset))
            offset += n
    return flat, layout


def create_train_state(model: EDMPrecond, optimizer: FusedAdamEma) -> TrainState:
    """Flatten the model's parameters (on its device), copy them into the
    EMA, and attach a zero gradient accumulator as the parameters' .grad."""
    params, layout = flatten_parameters(model)
    grads = torch.zeros_like(params)
    for (_, shape, off), p in zip(layout, model.parameters()):
        p.grad = grads[off:off + shape.numel()].view(shape)
    return TrainState(
        step=0, model=model, params=params, grads=grads, ema=params.clone(),
        opt_state=optimizer.init(params), layout=layout,
    )


class StepDraws(NamedTuple):
    """Random values of one step over the whole batch, injected in place of
    the step's own draws (for parity tests): unit normals for the moments,
    uniforms for the label dropout, sigma (N,), unit normals for the noise,
    and the mask."""

    z_noise: Optional[torch.Tensor] = None
    drop_u: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    mask_info: Optional[MaskInfo] = None


def _rows(x, sl: slice):
    if x is None:
        return None
    if isinstance(x, MaskInfo):
        return MaskInfo(*(t[sl] for t in x))
    return x[sl]


def make_train_step(
    optimizer: FusedAdamEma,
    loss_fn: Optional[EDMLoss] = None,
    mask_ratio: float = 0.5,
    mae_loss_coef: float = 0.0,
    class_dropout_prob: float = 0.1,
    ema_decay: float = 0.9999,
    grad_accum: int = 1,
    scale_factor: float = 0.18215,
    reparam_moments: bool = True,
    log_grad_norm: bool = True,
    ema_every: int = 1,
):
    """Build ``train_step(state, batch, generator=None, draws=None) ->
    metrics``, which updates ``state`` in place.

    batch: {'x': (N, C or 2C, H, W) latents or moments, 'y': (N, K)
    one-hot}, on the model's device. The metrics are 0-d tensors (read
    them at log time, so the step does not wait for the device).
    """
    if ema_every != 1:
        raise NotImplementedError("ema_every > 1 is not ported (the EMA runs every step)")
    loss_fn = loss_fn or EDMLoss()

    def train_step(state: TrainState, batch: dict, generator=None,
                   draws: Optional[StepDraws] = None) -> dict[str, torch.Tensor]:
        model = state.model
        draws = draws or StepDraws()
        x = batch["x"].float()
        if reparam_moments and x.shape[1] == 2 * model.img_channels:
            x = reparameterize_moments(x, scale_factor, generator, noise=draws.z_noise)
        y = batch.get("y")
        if y is not None and class_dropout_prob > 0:
            u = draws.drop_u
            if u is None:
                u = torch.rand((y.shape[0], 1), generator=generator, device=y.device)
            y = y * (u >= class_dropout_prob).to(y.dtype)

        state.grads.zero_()
        micro = x.shape[0] // grad_accum
        loss_sum, aux_sum = 0.0, {}
        for i in range(grad_accum):
            rows = slice(i * micro, (i + 1) * micro)
            loss_vec, aux = loss_fn(
                model, x[rows], labels=_rows(y, rows), mask_ratio=mask_ratio,
                mae_loss_coef=mae_loss_coef, patch_size=model.model.patch_size,
                generator=generator, sigma=_rows(draws.sigma, rows),
                noise=_rows(draws.noise, rows), mask_info=_rows(draws.mask_info, rows),
            )
            loss = loss_vec.mean()
            loss.backward()  # adds into state.grads, the parameters' .grad
            loss_sum = loss_sum + loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        if grad_accum > 1:
            state.grads.div_(grad_accum)

        with torch.no_grad():
            optimizer.update_with_ema(
                state.grads, state.opt_state, state.params, state.ema, ema_decay=ema_decay
            )
        state.step += 1
        metrics = {"loss": loss_sum / grad_accum}
        metrics.update({k: v / grad_accum for k, v in aux_sum.items()})
        if log_grad_norm:
            metrics["grad_norm"] = torch.linalg.vector_norm(state.grads)
        return metrics

    return train_step
