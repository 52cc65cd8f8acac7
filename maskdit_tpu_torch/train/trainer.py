"""Config-driven training loop on one device.

Counterpart of maskdit_tpu/train/trainer.py (the reference train.py:35-291)
without the mesh, sharding, orbax, WDS streaming, the eval hook and
pad-to-max masking. Kept: the experiment naming, mask-ratio bucketing with
one train step per bucket, the learning-rate schedule mirror for logging,
resume from the newest checkpoint (each step's draws are seeded from the
seed and the step, so a resumed run draws what a straight run would), the
save on SIGTERM/SIGINT, and the log line (loss, steps/s, images/s, MFU, peak
device memory). Model keys the port does not build yet raise (see
``check_model_keys``).

On a CUDA device every attention call and every optimizer update launches
the port's kernels; there is no switch. ``model.use_flash`` picks the
attention as the JAX trainer reads it: true for ops/flash.py's kernels,
false for the plain path, null or absent for auto (``default_use_flash``).
"""

from __future__ import annotations

import os
import signal
from typing import Any, Optional

import numpy as np
import torch

from maskdit_tpu_torch.data.datasets import SyntheticLatentDataset
from maskdit_tpu_torch.data.loader import DataLoader, prefetch, to_device
from maskdit_tpu_torch.models.precond import check_model_keys, create_model
from maskdit_tpu_torch.train.schedules import bucket_ratio, get_mask_ratio_fn
from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step
from maskdit_tpu_torch.utils.ckpt import CheckpointManager, load_reference_checkpoint
from maskdit_tpu_torch.utils.logging import MetricLogger, Throughput
from maskdit_tpu_torch.utils.profiling import maskdit_train_flops_per_image, mfu, peak_bf16_tflops

# train.* keys of the JAX trainer that the port does not implement yet
NOT_PORTED = {
    "amp_grads": False, "accum_dtype": None, "nu_dtype": None, "pad_to_max": False,
    "ema_every": 1, "accum_unroll": 1, "peel_last_micro": False,
}


def step_seed(seed: int, step: int) -> int:
    """The seed of the draws of train step ``step`` (moment noise, label
    dropout, sigma, noise, masks): a function of (seed, step) alone, as the
    JAX trainer folds the step into its key (``fold_in(rng, state.step)``,
    maskdit_tpu/train/state.py:338). So a run resumed at step k draws what a
    straight run draws at step k. The numbers are not threefry's."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def default_use_flash(grad_accum: int, seq_len: int) -> Optional[bool]:
    """The attention kernels' default, with the JAX trainer's semantics
    (maskdit_tpu/train/trainer.py:85-95): a config that accumulates
    gradients over short sequences (L < 512) runs the plain attention
    (False); every other config stays on auto (None). The JAX package chose
    this from times on a TPU; whether plain attention beats the packed
    kernels under accumulation on the card is not measured (ROADMAP.md,
    section C)."""
    return False if (grad_accum > 1 and seq_len < 512) else None


def build_dataset(config: dict) -> SyntheticLatentDataset:
    data = config["data"]
    category = data.get("category", "lmdb")
    if category != "synthetic":
        raise NotImplementedError(
            f"data.category '{category}': the port reads the synthetic latent "
            "dataset only so far"
        )
    return SyntheticLatentDataset(
        length=data.get("length", 512),
        resolution=data["resolution"],
        num_channels=data["num_channels"],
        label_dim=config["model"]["num_classes"],
    )


def experiment_name(config: dict, global_batch: int) -> str:
    """Reference exp-dir naming (train.py:92-94)."""
    m, t = config["model"], config["train"]
    cond = "cond" if m["num_classes"] else "uncond"
    return (
        f"{m['model_type'].replace('/', '-')}-{m['precond']}-{config['data']['dataset']}"
        f"-{cond}-m{m['mask_ratio']}-de{int(m['use_decoder'])}-mae{m['mae_loss_coef']}"
        f"-bs-{global_batch}-lr{t['lr']}{config.get('log', {}).get('tag', '')}"
    )


class Trainer:
    def __init__(
        self,
        config: dict,
        results_dir: str = "results",
        seed: int = 0,
        ckpt_path: Optional[str] = None,
        num_workers: int = 2,
        max_steps_override: Optional[int] = None,
        device: str = "cuda",
    ):
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        m, t = config["model"], config["train"]
        for key, default in NOT_PORTED.items():
            if t.get(key, default) != default:
                raise NotImplementedError(f"train.{key}={t[key]!r} is not ported yet")
        if m.get("precond", "edm") != "edm":
            raise NotImplementedError(f"model.precond '{m['precond']}' is not ported (edm only)")
        check_model_keys(m)
        data = config["data"]
        if data.get("streaming", False) and data.get("category") not in ("wds", "webdataset"):
            # the JAX trainer's check (maskdit_tpu/train/trainer.py:225-233)
            raise ValueError("data.streaming requires data.category: wds")

        self.grad_accum = t.get("grad_accum", 1)
        self.global_batch = t["batchsize"] * self.grad_accum
        self.max_steps = max_steps_override or t["max_num_steps"]
        self.mask_ratio_fn = get_mask_ratio_fn(
            m.get("mask_ratio_fn", "constant"), m["mask_ratio"], m.get("mask_ratio_min", 0.0)
        )
        self.seq_len = (m["in_size"] // int(m["model_type"].rsplit("/", 1)[1])) ** 2
        self.exp_name = experiment_name(config, self.global_batch)
        self.exp_dir = os.path.join(results_dir, self.exp_name)
        os.makedirs(self.exp_dir, exist_ok=True)

        torch.manual_seed(seed)  # the parameters' initialisation
        self.model = create_model(
            "edm",
            img_resolution=m["in_size"],
            img_channels=m["in_channels"],
            num_classes=m["num_classes"],
            model_type=m["model_type"],
            use_decoder=m["use_decoder"],
            mae_loss_coef=m["mae_loss_coef"],
            dtype=torch.float32 if t.get("fp32", False) else torch.bfloat16,
            # an explicit model.use_flash wins (null means auto); see
            # default_use_flash
            use_flash=m.get("use_flash", default_use_flash(self.grad_accum, self.seq_len)),
        ).to(self.device)
        self.optimizer = make_optimizer(
            t["lr"],
            global_batch_size=self.global_batch,
            rampup_kimg=t.get("lr_rampup_kimg", 0) or 0,
            fused=bool(t.get("fused_adam", True)),
            moment_dtype=t.get("moment_dtype"),
        )
        self.state = create_train_state(self.model, self.optimizer)

        self.ckpt_mgr = CheckpointManager(os.path.join(self.exp_dir, "checkpoints"))
        self.start_step = 0
        if ckpt_path is not None and ckpt_path.endswith(".pt"):
            # import a released checkpoint (the finetune path)
            self.state.load({
                "model": load_reference_checkpoint(ckpt_path, use_ema=False),
                "ema": load_reference_checkpoint(ckpt_path, use_ema=True),
            })
            print(f"imported reference checkpoint {ckpt_path}")
        elif self.ckpt_mgr.latest_step() is not None:
            self.state.load(self.ckpt_mgr.restore())
            self.start_step = self.state.step
            print(f"resumed from step {self.start_step}")

        self.dataset = build_dataset(config)
        self.loader = DataLoader(
            self.dataset, self.global_batch, shuffle=True, seed=seed,
            num_workers=num_workers, resample=config["data"].get("resampled", False),
        )
        self.metrics = MetricLogger(self.exp_dir, config=config)
        self.peak_tflops = (
            peak_bf16_tflops(torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else None
        )
        self.history: list[dict[str, Any]] = []
        self._step_cache: dict[float, Any] = {}

    def lr_at(self, step: int) -> float:
        """The schedule's learning rate after ``step`` steps (train/lr)."""
        return self.optimizer.lr_at(step)

    def _step_for_ratio(self, ratio: float):
        ratio = bucket_ratio(ratio, self.seq_len)
        if ratio not in self._step_cache:
            m, t = self.config["model"], self.config["train"]
            self._step_cache[ratio] = make_train_step(
                self.optimizer,
                mask_ratio=ratio,
                mae_loss_coef=m["mae_loss_coef"],
                class_dropout_prob=m.get("class_dropout_prob", 0.1),
                ema_decay=t.get("ema_decay", 0.9999),
                grad_accum=self.grad_accum,
            )
        return self._step_cache[ratio]

    def _log(self, step: int, running: list[dict], ratio: float, throughput: Throughput) -> None:
        losses = [float(r["loss"]) for r in running]  # waits for the device
        avg = {k: float(np.mean([float(r[k]) for r in running])) for k in running[0]}
        rates = throughput.rates()
        util = None
        if self.peak_tflops is not None:
            flops = maskdit_train_flops_per_image(
                self.config["model"]["model_type"], self.config["model"]["in_size"],
                ratio, self.config["model"]["use_decoder"],
            )
            util = mfu(rates["images_per_sec"], flops, self.peak_tflops)
        peak_gib = (torch.cuda.max_memory_allocated(self.device) / 1024 ** 3
                    if self.device.type == "cuda" else None)
        print(
            f"(step={step:07d}) loss={avg['loss']:.4f} "
            f"steps/sec={rates['steps_per_sec']:.3f} "
            f"imgs/sec={rates['images_per_sec']:.1f} "
            f"mfu={'n/a' if util is None else f'{util:.1%}'} mask_ratio={ratio:.3f} "
            f"mem_peak={'n/a' if peak_gib is None else f'{peak_gib:.1f}GiB'}",
            flush=True,
        )
        record = {"step": step, "losses": losses, **avg, **rates, "mfu": util,
                  "mem_peak_gib": peak_gib, "lr": self.lr_at(step), "mask_ratio": ratio}
        self.history.append(record)
        self.metrics.log(
            {f"train/{k}": v for k, v in record.items()
             if k not in ("step", "losses") and v is not None},
            step,
        )

    def train(self, log_every: Optional[int] = None, ckpt_every: Optional[int] = None) -> int:
        log_cfg = self.config["log"]
        log_every = log_every or log_cfg["log_every"]
        ckpt_every = ckpt_every or log_cfg["ckpt_every"]

        # on SIGTERM/SIGINT finish the current step, save, and stop
        stop = {"flag": False}

        def request_stop(signum, frame):
            print(f"signal {signum}: checkpointing and stopping...", flush=True)
            stop["flag"] = True

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, request_stop)
            except ValueError:
                pass  # not the main thread
        generator = torch.Generator(self.device)
        throughput = Throughput()
        running: list[dict] = []
        step = self.start_step
        ratio = float(self.mask_ratio_fn(0.0))
        print(f"training {self.exp_name}: global batch {self.global_batch}, "
              f"{len(self.dataset):,} samples, max {self.max_steps} steps, "
              f"device {self.device}", flush=True)
        try:
            for host_batch in prefetch(iter(self.loader)):
                if step >= self.start_step + self.max_steps or stop["flag"]:
                    break
                progress = (step - self.start_step) / max(self.max_steps, 1)
                ratio = float(self.mask_ratio_fn(progress))
                step_fn = self._step_for_ratio(ratio)
                generator.manual_seed(step_seed(self.seed + 1, step))
                running.append(step_fn(self.state, to_device(host_batch, self.device), generator))
                step += 1
                throughput.update(1, self.global_batch)
                if step % log_every == 0:
                    self._log(step, running, ratio, throughput)
                    running = []
                    throughput.reset()
                if step % ckpt_every == 0:
                    self.ckpt_mgr.save(step, self.state.checkpoint())
                    print(f"checkpoint saved at step {step}", flush=True)
            if running:
                self._log(step, running, ratio, throughput)
            if step not in self.ckpt_mgr.all_steps():
                self.ckpt_mgr.save(step, self.state.checkpoint())
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            self.metrics.close()
        print(f"training done at step {step}", flush=True)
        return step
