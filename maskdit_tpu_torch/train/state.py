"""Train state and the training step.

Counterpart of maskdit_tpu/train/state.py. One step covers the hot loop of
the reference train.py:198-287: moments -> z (utils.py:59-65), label
dropout for CFG (train.py:208-209), gradient accumulation over micro-batches
(train.py:211-227), the EDM loss, and Adam with the EMA update
(helper.py:48-58) in one fused sweep or, with ``train.fused_adam: false``,
in optax's stages (``make_optimizer``).

Numerics as in the JAX package: parameters, Adam moments and EMA are fp32
(the moments may be stored in bf16: ``moment_dtype``, ``nu_dtype``); each
Linear computes in the model's compute dtype (bf16 by default) inside
autograd, so the gradients are fp32, or bf16 under ``amp_grads``, which
differentiates against a bf16 copy of the fp32 parameters
(state.py:354-357). With ``grad_accum > 1`` each micro-batch's gradient is
added into an accumulator of ``accum_dtype`` (default fp32, the
parameters' dtype) as ``s + g_i.astype(s.dtype)`` and the sum divided by
``grad_accum`` in that dtype (state.py:401-409); with one micro-batch the
gradient goes to the update as it is. ``ema_every = k`` moves the EMA on
the steps with ``(step + 1) % k == 0`` only, with decay ``decay**k``
(state.py:170-224).

Memory layout: the parameters, their gradient accumulator, the EMA and both
moments are each ONE flat buffer. The model's parameters are views into
``params`` (or into its bf16 copy ``net_params`` under ``amp_grads``) and
their ``.grad`` views into the accumulator ``grads`` (autograd adds each
micro-batch's gradient into it in place), or into ``micro_grads`` when a
micro-batch's gradient has another dtype than the accumulator. So the
fused update is a single kernel launch over all leaves.
``TrainState.named`` gives the per-parameter views under the state-dict
keys.

Every step takes its random values through ``draw_step``, over the whole
batch. Data parallelism (``parallel/data_parallel.py``): each process runs
the step on its rows of the global batch with ``draw_step``'s draws of the
whole global batch, all-reduces the gradient once and updates its whole
replica.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn as nn

from maskdit_tpu_torch.models.masking import (
    MaskInfo,
    padded_len_keep,
    padded_random_mask,
    random_mask,
)
from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.ops.fused_adam import AdamState, FusedAdamEma, StagedAdamEma
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.schedules import lr_with_rampup
from maskdit_tpu_torch.utils.ckpt import graft_params

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's dtype name (None, 'float32' or 'bfloat16') as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: float32 or bfloat16")
    return _DTYPES[name]


def reparameterize_moments(
    moments: torch.Tensor, noise: torch.Tensor, scale_factor: float = 0.18215,
) -> torch.Tensor:
    """VAE moments (N, 2C, H, W) and unit normals (N, C, H, W) -> z
    (N, C, H, W) (reference: utils.py:59-65)."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    std = torch.exp(0.5 * logvar)
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
    (reference: train.py:141, 223-226), with the JAX ``make_optimizer``'s
    choices (maskdit_tpu/train/state.py:54-136) and its errors.

    ``fused`` (``train.fused_adam``, default true): the fused Adam + EMA
    update, kernel #7. Else the staged update (``StagedAdamEma``): the JAX
    package's ``optax.adam``, ``optax.adamw`` where ``weight_decay`` is not 0,
    or ``adam_sr_nu`` with ``nu_dtype``. ``moment_dtype='bfloat16'`` stores
    the first moment in bf16 (the math stays fp32); ``nu_dtype='bfloat16'``
    the second, with stochastic rounding (ops/fused_adam.py).
    """
    if nu_dtype is not None and weight_decay != 0.0:
        # the JAX guard (state.py:93-97)
        raise NotImplementedError(
            "nu_dtype with weight_decay: the reference trains at wd=0 "
            "(configs/train/*.yaml); chain add_decayed_weights if needed"
        )
    if rampup_kimg > 0:
        schedule = lambda step: lr_with_rampup(step, base_lr, global_batch_size, rampup_kimg)
    else:
        schedule = base_lr
    kwargs = dict(learning_rate=schedule, b1=betas[0], b2=betas[1], eps=eps,
                  mu_dtype=dtype_of(moment_dtype))
    nu = dtype_of(nu_dtype)
    if fused:
        if weight_decay != 0.0:
            raise NotImplementedError(
                "fused Adam+EMA implements wd=0 (the reference setting, configs/train/*.yaml)"
            )
        return FusedAdamEma(nu_dtype=nu, **kwargs)  # raises on a nu other than bf16
    if nu not in (None, torch.bfloat16):
        raise ValueError(f"nu_dtype={nu_dtype}: only bfloat16 supported")
    return StagedAdamEma(weight_decay=weight_decay, nu_dtype=nu, **kwargs)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters views into ``params``, or into its bf16
    copy ``net_params`` under ``amp_grads``), the flat buffers, the
    optimizer state and the step count. ``grads`` is the gradient the
    update reads (the accumulator); ``micro_grads`` holds one micro-batch's
    gradient where its dtype is not the accumulator's."""

    step: int
    model: EDMPrecond
    params: torch.Tensor
    grads: torch.Tensor
    ema: torch.Tensor
    opt_state: AdamState
    layout: list[tuple[str, torch.Size, int]]
    net_params: Optional[torch.Tensor] = None
    micro_grads: Optional[torch.Tensor] = None
    # the (gradient, accumulator) dtypes the parameters are bound for
    binding: tuple = (torch.float32, torch.float32)

    def named(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Per-parameter views of a flat buffer, under the state-dict keys."""
        return {
            name: flat[off:off + shape.numel()].view(shape)
            for name, shape, off in self.layout
        }

    def bind(self, grad_dtype: torch.dtype, accum_dtype: torch.dtype) -> None:
        """Point the model's parameters and their ``.grad`` at buffers for
        gradients of ``grad_dtype`` added into an accumulator of
        ``accum_dtype`` (allocated on first use; a no-op when bound so)."""
        if self.binding == (grad_dtype, accum_dtype):
            return
        if self.grads.dtype != accum_dtype:
            self.grads = torch.zeros_like(self.params, dtype=accum_dtype)
        if grad_dtype == torch.float32:
            self.net_params = None
            net = self.params
        else:
            if self.net_params is None or self.net_params.dtype != grad_dtype:
                self.net_params = self.params.to(grad_dtype)
            net = self.net_params
        if grad_dtype == accum_dtype:
            self.micro_grads = None
            grad = self.grads
        else:
            if self.micro_grads is None or self.micro_grads.dtype != grad_dtype:
                self.micro_grads = torch.zeros_like(self.params, dtype=grad_dtype)
            grad = self.micro_grads
        for (_, shape, off), p in zip(self.layout, self.model.parameters()):
            p.data = net[off:off + shape.numel()].view(shape)
            p.grad = grad[off:off + shape.numel()].view(shape)
        self.binding = (grad_dtype, accum_dtype)

    def checkpoint(self) -> dict[str, Any]:
        """``{model, ema, opt, step}`` on the CPU, in the reference ``.pt``
        layout (train.py:259-268); ``opt`` is optax's (count, mu, nu), each
        moment in its storage dtype."""
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

    def load(self, ckpt: dict[str, Any], strict: bool = True) -> list[str]:
        """Restore from ``checkpoint()``'s dict: every entry it has is
        copied into the flat buffers. ``strict`` (a resume) needs every
        parameter; without it (``model`` and ``ema`` of a released
        checkpoint: the finetune import) a parameter the file lacks keeps
        its value and its name is returned as ``'<entry>.<key>'``. Keys the
        model lacks are ignored; a shape that differs raises ValueError."""
        missing = []
        with torch.no_grad():
            for key, flat in (("model", self.params), ("ema", self.ema)):
                if key in ckpt:
                    missing += _copy_named(self.named(flat), ckpt[key], key, strict)
            if "opt" in ckpt:
                self.load_opt_state(ckpt["opt"])
        if "step" in ckpt:
            self.step = int(ckpt["step"])
        return missing

    def load_opt_state(self, opt: dict[str, Any]) -> None:
        """Adam's count, mu and nu from ``{count, mu, nu}`` dicts keyed like
        the parameters (``utils.port.optimizer_state_from_flax``), cast to
        the moments' storage dtypes (exact for values saved in them)."""
        with torch.no_grad():
            _copy_named(self.named(self.opt_state.mu), opt["mu"], "opt.mu")
            _copy_named(self.named(self.opt_state.nu), opt["nu"], "opt.nu")
        self.opt_state.count = int(opt["count"])


def _copy_named(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], what: str,
                strict: bool = True) -> list[str]:
    missing = sorted(set(dst) - set(src))
    if strict and missing:
        raise KeyError(f"{what}: no values for {missing[:5]} ({len(missing)} keys)")
    return [f"{what}.{k}" for k in graft_params(dst, src)]


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
    the step's own draws (for parity tests, and for a process of a
    data-parallel run, which keeps its rows of the global batch's draws):
    unit normals for the moments, uniforms for the label dropout, sigma
    (N,), unit normals for the noise, and the mask."""

    z_noise: Optional[torch.Tensor] = None
    drop_u: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    mask_info: Optional[MaskInfo] = None


def _rows(x, sl: slice):
    if x is None:
        return None
    if isinstance(x, MaskInfo):  # len_keep is one count for every row
        return MaskInfo(x.mask[sl], x.ids_keep[sl], x.ids_restore[sl], x.len_keep)
    return x[sl]


def draw_step(
    generator: Optional[torch.Generator], n: int, shape: tuple[int, ...],
    device: torch.device, *, grad_accum: int, reparam: bool, dropout: bool,
    mask_ratio: float, patch_size: int, loss_fn: EDMLoss,
    mask_len_max: Optional[int] = None,
) -> StepDraws:
    """Every draw of a step on a batch of ``n`` rows of latents of
    ``shape`` (C, H, W), in the order and shapes the step takes them from
    ``generator`` itself: the moment noise and the dropout uniforms over
    the batch, then sigma, the noise and the mask of each micro-batch.
    So the draws of a one-process step on the global batch. With
    ``mask_len_max`` (pad-to-max) every micro-batch draws a padded mask
    from the same uniforms, at any ratio, 0 included."""
    c, h, w = shape
    z_noise = (torch.randn((n, c, h, w), generator=generator, device=device)
               if reparam else None)
    drop_u = torch.rand((n, 1), generator=generator, device=device) if dropout else None
    micro = n // grad_accum
    tokens = (h // patch_size) * (w // patch_size)
    len_keep = None if mask_len_max is None else padded_len_keep(tokens, mask_ratio, device)
    sigmas, noises, masks = [], [], []
    for _ in range(grad_accum):
        rnd_normal = torch.randn((micro, 1, 1, 1), generator=generator, device=device)
        sigmas.append(torch.exp(rnd_normal * loss_fn.P_std + loss_fn.P_mean).reshape(-1))
        noises.append(torch.randn((micro, c, h, w), generator=generator, device=device))
        if len_keep is not None:
            masks.append(padded_random_mask(micro, tokens, mask_len_max, len_keep, generator,
                                            device=device))
        elif float(mask_ratio) > 0:
            masks.append(random_mask(micro, tokens, mask_ratio, generator, device=device))
    mask_info = None
    if masks:
        mask_info = MaskInfo(*(torch.cat(t) for t in zip(*(m[:3] for m in masks))), len_keep)
    return StepDraws(z_noise, drop_u, torch.cat(sigmas), torch.cat(noises), mask_info)


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
    amp_grads: bool = False,
    accum_dtype: Optional[str] = None,
    sync: Optional[Any] = None,
    pad_to_max: bool = False,
    mask_len_max: Optional[int] = None,
    debug_nans: bool = False,
):
    """Build ``train_step(state, batch, generator=None, draws=None) ->
    metrics``, which updates ``state`` in place.

    batch: {'x': (N, C or 2C, H, W) latents or moments, 'y': (N, K)
    one-hot, and 'feat' (N, F) external features where the model takes
    them}, on the model's device; 'feat' is split over the micro-batches as
    'x' and 'y' are (JAX state.py:319-432). The metrics are 0-d tensors
    (read them at log time, so the step does not wait for the device).

    ``pad_to_max`` (JAX state.py:240-330) makes one step serve every mask
    ratio: the ratio arrives as ``batch['mask_ratio']``, and the encoder
    runs at ``mask_len_max`` tokens (default all L) of which the ratio's
    first ``len_keep`` are valid, through the plain attention with the key
    mask. It computes the packed step's function at that ratio.

    Without ``draws`` the step takes its own from ``generator`` through
    ``draw_step``, over the whole batch. ``sync`` (a
    ``parallel.data_parallel.DataParallel``) makes the step one process's
    share of a data-parallel step: ``batch`` holds this process's rows of
    the global batch (rank r's rows follow rank r-1's), its draws are
    ``draw_step``'s over the whole global batch restricted to its rows, and
    the gradient and the metrics are averaged over the processes before the
    update.

    ``debug_nans`` (the train CLI's ``--debug_nans``, where the JAX CLI sets
    ``jax_debug_nans``): the loss and the gradient are checked before the
    update and the parameters after it, and the first that holds a NaN
    raises ``FloatingPointError`` naming the step (the steps done before
    it) and the tensor, before the update where it can. As with
    ``jax_debug_nans``, an infinity alone does not raise (JAX checks those
    under ``jax_debug_infs``); Adam turns an infinite gradient into NaN
    parameters, which do. Each check waits for the device; without the
    flag there is none.
    """
    loss_fn = loss_fn or EDMLoss()
    grad_dtype = torch.bfloat16 if amp_grads else torch.float32
    # the accumulator's dtype: the gradient's with one micro-batch (no
    # accumulation), else accum_dtype or the parameters' (fp32)
    acc_dtype = grad_dtype if grad_accum == 1 else (dtype_of(accum_dtype) or torch.float32)
    # the EMA's decay on its steps, formed in double and rounded to fp32 by
    # adam_scalars (state.py:196)
    decay_k = ema_decay ** ema_every

    def train_step(state: TrainState, batch: dict, generator=None,
                   draws: Optional[StepDraws] = None) -> dict[str, torch.Tensor]:
        model = state.model
        state.bind(grad_dtype, acc_dtype)
        x = batch["x"].float()
        y = batch.get("y")
        feat = batch.get("feat")
        patch = model.model.patch_size
        ratio, len_max = mask_ratio, None
        if pad_to_max:
            ratio = batch["mask_ratio"]
            len_max = mask_len_max or (x.shape[2] // patch) * (x.shape[3] // patch)
        reparam = reparam_moments and x.shape[1] == 2 * model.img_channels
        dropout = y is not None and class_dropout_prob > 0
        if draws is None:
            n = x.shape[0]
            rank, world = (0, 1) if sync is None else (sync.rank, sync.world)
            draws = draw_step(
                generator, n * world, (model.img_channels, *x.shape[2:]), x.device,
                grad_accum=grad_accum, reparam=reparam, dropout=dropout,
                mask_ratio=ratio, patch_size=patch, loss_fn=loss_fn, mask_len_max=len_max,
            )
            if sync is not None:  # this process's rows of the global batch's draws
                draws = StepDraws(*(_rows(d, slice(rank * n, (rank + 1) * n)) for d in draws))
        if reparam:
            x = reparameterize_moments(x, draws.z_noise, scale_factor)
        if dropout:
            y = y * (draws.drop_u >= class_dropout_prob).to(y.dtype)

        if state.net_params is not None:
            with torch.no_grad():
                state.net_params.copy_(state.params)  # the bf16 copy, rounded once
        state.grads.zero_()
        micro = x.shape[0] // grad_accum
        loss_sum, aux_sum = 0.0, {}
        for i in range(grad_accum):
            rows = slice(i * micro, (i + 1) * micro)
            if state.micro_grads is not None:
                state.micro_grads.zero_()
            loss_vec, aux = loss_fn(
                model, x[rows], labels=_rows(y, rows), mask_ratio=ratio,
                mae_loss_coef=mae_loss_coef, patch_size=patch,
                sigma=_rows(draws.sigma, rows),
                noise=_rows(draws.noise, rows), mask_info=_rows(draws.mask_info, rows),
                mask_len_max=len_max, feat=_rows(feat, rows),
            )
            loss = loss_vec.mean()
            loss.backward()  # adds into the parameters' .grad
            if state.micro_grads is not None:
                with torch.no_grad():  # s + g_i.astype(s.dtype)
                    state.grads.add_(state.micro_grads.to(acc_dtype))
            loss_sum = loss_sum + loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        if grad_accum > 1:
            state.grads.div_(grad_accum)
        if sync is not None:
            sync.mean_gradient_(state.grads)
        grads = state.grads
        if debug_nans:
            _raise_if_nan(state, "the loss", loss_sum)
            _raise_if_nan(state, "the gradient", grads)

        with_ema = (state.step + 1) % ema_every == 0
        with torch.no_grad():
            optimizer.update_with_ema(
                grads, state.opt_state, state.params, state.ema,
                ema_decay=decay_k if with_ema else 1.0, with_ema=with_ema,
            )
        if debug_nans:
            _raise_if_nan(state, "the updated parameters", state.params)
        state.step += 1
        metrics = {"loss": loss_sum / grad_accum}
        metrics.update({k: v / grad_accum for k, v in aux_sum.items()})
        if sync is not None:
            metrics = sync.mean_metrics(metrics)
        if log_grad_norm:
            metrics["grad_norm"] = torch.linalg.vector_norm(grads)
        return metrics

    return train_step


def _raise_if_nan(state: TrainState, what: str, value: torch.Tensor) -> None:
    """``FloatingPointError`` if ``value`` (the loss, or a flat buffer of
    ``state``'s layout) holds a NaN, naming the step and, for a flat
    buffer, its first parameter that does."""
    if not bool(torch.isnan(value).any()):
        return
    if value.dim() == 1 and value.numel() == state.params.numel():
        name = next(k for k, v in state.named(value).items() if bool(torch.isnan(v).any()))
        what = f"{what} ({name} first)"
    raise FloatingPointError(f"debug_nans: {what} holds a NaN at train step {state.step}")
