"""Train state and the training step.

Counterpart of maskdit_tpu/train/state.py. One step covers the hot loop of
the reference train.py:198-287: moments -> z (utils.py:59-65), label
dropout for CFG (train.py:208-209), gradient accumulation over micro-batches
(train.py:211-227), the EDM loss, and Adam with the EMA update
(helper.py:48-58) in one fused sweep.

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

from maskdit_tpu_torch.models.masking import MaskInfo, random_mask
from maskdit_tpu_torch.models.precond import EDMPrecond
from maskdit_tpu_torch.ops.fused_adam import AdamState, FusedAdamEma
from maskdit_tpu_torch.train.loss import EDMLoss
from maskdit_tpu_torch.train.schedules import lr_with_rampup

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
    (reference: train.py:141, 223-226), as the fused Adam + EMA update.

    ``moment_dtype='bfloat16'`` stores the first moment in bf16 (the math
    stays fp32); ``nu_dtype='bfloat16'`` the second, with stochastic
    rounding (ops/fused_adam.py). The staged optax path and weight decay
    are not ported: the released configs train with the fused update at
    wd 0.
    """
    if nu_dtype is not None and weight_decay != 0.0:
        # the JAX guard (state.py:93-97)
        raise NotImplementedError(
            "nu_dtype with weight_decay: the reference trains at wd=0 (configs/train/*.yaml)"
        )
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
        mu_dtype=dtype_of(moment_dtype), nu_dtype=dtype_of(nu_dtype),
    )


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
        the parameters (``utils.port.optimizer_state_from_flax``), cast to
        the moments' storage dtypes (exact for values saved in them)."""
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
    if isinstance(x, MaskInfo):
        return MaskInfo(*(t[sl] for t in x))
    return x[sl]


def draw_step(
    generator: Optional[torch.Generator], n: int, shape: tuple[int, ...],
    device: torch.device, *, grad_accum: int, reparam: bool, dropout: bool,
    mask_ratio: float, patch_size: int, loss_fn: EDMLoss,
) -> StepDraws:
    """Every draw of a step on a batch of ``n`` rows of latents of
    ``shape`` (C, H, W), in the order and shapes the step takes them from
    ``generator`` itself: the moment noise and the dropout uniforms over
    the batch, then sigma, the noise and the mask of each micro-batch.
    So the draws of a one-process step on the global batch."""
    c, h, w = shape
    z_noise = (torch.randn((n, c, h, w), generator=generator, device=device)
               if reparam else None)
    drop_u = torch.rand((n, 1), generator=generator, device=device) if dropout else None
    micro = n // grad_accum
    sigmas, noises, masks = [], [], []
    for _ in range(grad_accum):
        rnd_normal = torch.randn((micro, 1, 1, 1), generator=generator, device=device)
        sigmas.append(torch.exp(rnd_normal * loss_fn.P_std + loss_fn.P_mean).reshape(-1))
        noises.append(torch.randn((micro, c, h, w), generator=generator, device=device))
        if float(mask_ratio) > 0:
            masks.append(random_mask(micro, (h // patch_size) * (w // patch_size), mask_ratio,
                                     generator, device=device))
    mask_info = MaskInfo(*(torch.cat(t) for t in zip(*masks))) if masks else None
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
):
    """Build ``train_step(state, batch, generator=None, draws=None) ->
    metrics``, which updates ``state`` in place.

    batch: {'x': (N, C or 2C, H, W) latents or moments, 'y': (N, K)
    one-hot}, on the model's device. The metrics are 0-d tensors (read
    them at log time, so the step does not wait for the device).

    Without ``draws`` the step takes its own from ``generator`` through
    ``draw_step``, over the whole batch. ``sync`` (a
    ``parallel.data_parallel.DataParallel``) makes the step one process's
    share of a data-parallel step: ``batch`` holds this process's rows of
    the global batch (rank r's rows follow rank r-1's), its draws are
    ``draw_step``'s over the whole global batch restricted to its rows, and
    the gradient and the metrics are averaged over the processes before the
    update.
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
        reparam = reparam_moments and x.shape[1] == 2 * model.img_channels
        dropout = y is not None and class_dropout_prob > 0
        if draws is None:
            n = x.shape[0]
            rank, world = (0, 1) if sync is None else (sync.rank, sync.world)
            draws = draw_step(
                generator, n * world, (model.img_channels, *x.shape[2:]), x.device,
                grad_accum=grad_accum, reparam=reparam, dropout=dropout,
                mask_ratio=mask_ratio, patch_size=model.model.patch_size, loss_fn=loss_fn,
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
                model, x[rows], labels=_rows(y, rows), mask_ratio=mask_ratio,
                mae_loss_coef=mae_loss_coef, patch_size=model.model.patch_size,
                sigma=_rows(draws.sigma, rows),
                noise=_rows(draws.noise, rows), mask_info=_rows(draws.mask_info, rows),
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

        with_ema = (state.step + 1) % ema_every == 0
        with torch.no_grad():
            optimizer.update_with_ema(
                grads, state.opt_state, state.params, state.ema,
                ema_decay=decay_k if with_ema else 1.0, with_ema=with_ema,
            )
        state.step += 1
        metrics = {"loss": loss_sum / grad_accum}
        metrics.update({k: v / grad_accum for k, v in aux_sum.items()})
        if sync is not None:
            metrics = sync.mean_metrics(metrics)
        if log_grad_norm:
            metrics["grad_norm"] = torch.linalg.vector_norm(grads)
        return metrics

    return train_step
