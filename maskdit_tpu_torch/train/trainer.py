"""Config-driven training loop, on one device or data-parallel.

Counterpart of maskdit_tpu/train/trainer.py (the reference train.py:35-291)
without the FSDP and tensor axes of its mesh and orbax. Under a process group of several processes
(``parallel/dist.py``) it trains data-parallel
(``parallel/data_parallel.py``): the global batch is ``batchsize x
grad_accum x processes``, each process reads its rank-strided rows,
rank 0 logs and writes the checkpoints, and every process resumes. Kept: the data
categories (synthetic, the latent LMDB, WebDataset shards indexed or
streamed), the experiment naming, mask-ratio bucketing with one train step per
bucket or, with ``train.pad_to_max``, one step for every ratio (the encoder
at the schedule's most kept tokens, the tail masked), the import of a
released ``.pt`` (``--ckpt_path``, always non-strict: the finetune path),
the learning-rate schedule mirror for logging, resume from the
newest checkpoint (each step's draws are seeded from the seed and the step,
so a resumed run draws what a straight run would), the save on
SIGTERM/SIGINT, the log line (loss, steps/s, images/s, MFU, peak device
memory) and the eval hook (``eval_hook(step, ema)`` after each checkpoint,
its metrics logged as ``eval/<name>``) and the train-step options
``amp_grads``, ``accum_dtype``, ``moment_dtype``, ``nu_dtype`` and
``ema_every``, ``fused_adam`` (false: the staged update) (``train/state.py``),
the CLI's ``--debug_nans`` and ``--use_wandb`` (the JAX trainer's
``MetricLogger`` with the config's ``wandb.*`` keys), and the model corners
``model.pad_cls_token`` and ``model.ext_feature_dim`` (with
``data.feat_path``, a feature LMDB joined to the latent LMDB; the batch's
features are dropped when the model takes none, as in the JAX trainer).
The train keys of ``NOT_PORTED`` raise.

On a CUDA device every attention call and every optimizer update launches
the port's kernels; there is no switch. ``model.use_flash`` picks the
attention as the JAX trainer reads it: true for ops/flash.py's kernels,
false for the plain path, null or absent for auto (``default_use_flash``).
"""

from __future__ import annotations

import os
import signal
from typing import Any, Callable, Optional

import numpy as np
import torch

from maskdit_tpu_torch.data.datasets import Dataset, ImageNetLatentDataset, SyntheticLatentDataset
from maskdit_tpu_torch.data.loader import DataLoader, prefetch, to_device
from maskdit_tpu_torch.data.wds import StreamingWDSLoader, WebDatasetLatents
from maskdit_tpu_torch.models.masking import len_keep_for
from maskdit_tpu_torch.models.precond import create_model
from maskdit_tpu_torch.parallel.data_parallel import data_parallel
from maskdit_tpu_torch.parallel.dist import (
    barrier, is_main_process, local_device, mprint, process_count, process_index,
)
from maskdit_tpu_torch.train.schedules import bucket_ratio, get_mask_ratio_fn
from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step
from maskdit_tpu_torch.utils.ckpt import CheckpointManager, load_reference_states
from maskdit_tpu_torch.utils.logging import MetricLogger, Throughput
from maskdit_tpu_torch.utils.profiling import maskdit_train_flops_per_image, mfu, peak_bf16_tflops

# train.* keys of the JAX trainer that the port does not implement: each
# key's default, and why
NOT_PORTED = {
    "accum_unroll": (1, "an XLA scheduling knob of the accumulation scan; the port's "
                        "micro-batches run one after another"),
    "peel_last_micro": (False, "an XLA scheduling knob of the accumulation scan; the "
                               "port's micro-batches run one after another"),
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


def build_dataset(config: dict) -> Dataset:
    """The training dataset that ``data.category`` names (the JAX trainer's
    ``build_dataset``, maskdit_tpu/train/trainer.py:52-82): ``synthetic``,
    ``lmdb`` (the latent LMDB at ``data.root``, with ``train.xflip``'s
    stored flips, read by the native reader) or
    ``wds`` / ``webdataset`` (the shards at ``data.root``, indexed)."""
    data, m = config["data"], config["model"]
    category = data.get("category", "lmdb")
    if category == "synthetic":
        return SyntheticLatentDataset(
            length=data.get("length", 512),
            resolution=data["resolution"],
            num_channels=data["num_channels"],
            label_dim=m["num_classes"],
        )
    if category == "lmdb":
        return ImageNetLatentDataset(
            data["root"],
            resolution=data["resolution"],
            num_channels=data["num_channels"],
            xflip=config["train"].get("xflip", False),
            feat_path=data.get("feat_path"),
            feat_dim=m.get("ext_feature_dim", 0),
            label_dim=m["num_classes"],
        )
    if category in ("wds", "webdataset"):
        return WebDatasetLatents(
            data["root"],
            resolution=data["resolution"],
            num_channels=data["num_channels"],
            label_dim=m["num_classes"],
        )
    raise ValueError(f"unknown data.category '{category}'")


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
        eval_hook: Optional[Callable[[int, dict], dict]] = None,
        use_wandb: bool = False,
        debug_nans: bool = False,
    ):
        # eval_hook(step, ema) -> metrics, with ema the EMA weights under the
        # state-dict keys; run after each checkpoint (reference train.py:273-287)
        self.eval_hook = eval_hook
        self.debug_nans = debug_nans
        self.config = config
        self.seed = seed
        # cuda without an index is cuda:LOCAL_RANK; ranks that share a
        # card name it (cuda:0)
        self.device = local_device(device)
        self.rank, self.world = process_index(), process_count()
        m, t = config["model"], config["train"]
        for key, (default, why) in NOT_PORTED.items():
            if t.get(key, default) != default:
                raise NotImplementedError(f"train.{key}={t[key]!r} is not ported: {why}")
        if m.get("precond", "edm") != "edm":
            raise NotImplementedError(f"model.precond '{m['precond']}' is not ported (edm only)")
        data = config["data"]
        if data.get("streaming", False) and data.get("category") not in ("wds", "webdataset"):
            # the JAX trainer's check (maskdit_tpu/train/trainer.py:225-233)
            raise ValueError("data.streaming requires data.category: wds")

        self.grad_accum = t.get("grad_accum", 1)
        self.pad_to_max = bool(t.get("pad_to_max", False))
        self.local_batch = t["batchsize"] * self.grad_accum
        self.global_batch = self.local_batch * self.world
        self.max_steps = max_steps_override or t["max_num_steps"]
        self.mask_ratio_fn = get_mask_ratio_fn(
            m.get("mask_ratio_fn", "constant"), m["mask_ratio"], m.get("mask_ratio_min", 0.0)
        )
        self.seq_len = (m["in_size"] // int(m["model_type"].rsplit("/", 1)[1])) ** 2
        self.exp_name = experiment_name(config, self.global_batch)
        self.exp_dir = os.path.join(results_dir, self.exp_name)
        if is_main_process():
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
            pad_cls_token=m.get("pad_cls_token", False),
            ext_feature_dim=m.get("ext_feature_dim", 0),
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
            nu_dtype=t.get("nu_dtype"),
        )
        self.state = create_train_state(self.model, self.optimizer)
        self.sync = data_parallel()

        self.ckpt_mgr = CheckpointManager(os.path.join(self.exp_dir, "checkpoints"))
        self.start_step = 0
        if ckpt_path is not None and ckpt_path.endswith(".pt"):
            # import a released checkpoint (the finetune path), always
            # non-strictly, as the JAX trainer does (trainer.py:203-217)
            missing = self.state.load(load_reference_states(ckpt_path), strict=False)
            kept = f"; kept at their initialisation: {missing}" if missing else ""
            mprint(f"imported reference checkpoint {ckpt_path}{kept}")
        elif self.ckpt_mgr.latest_step() is not None:
            self.state.load(self.ckpt_mgr.restore())  # every process resumes
            self.start_step = self.state.step
            mprint(f"resumed from step {self.start_step}")
        if self.sync is not None:
            # one replica: rank 0's parameters and EMA everywhere
            self.sync.broadcast_(self.state.params, self.state.ema)

        if data.get("streaming", False):
            # whole shards read linearly (the IO pattern network storage
            # needs; reference train_wds.py:35-42), whole shards per process
            self.dataset = None
            self.loader = StreamingWDSLoader(
                data["root"], self.local_batch, label_dim=m["num_classes"], seed=seed,
                shuffle_buffer=data.get("shuffle_buffer", 1000),
                resample=data.get("resampled", False),
            )
            source = f"{data['root']} (streamed shards)"
        else:
            self.dataset = build_dataset(config)
            self.loader = DataLoader(
                self.dataset, self.local_batch, shuffle=True, seed=seed,
                num_workers=num_workers, resample=data.get("resampled", False),
                process_index=self.rank, process_count=self.world,
            )
            source = f"{len(self.dataset):,} samples"
            if isinstance(self.dataset, ImageNetLatentDataset):
                source += f", {self.dataset.reader_kind} LMDB reader"
        if self.world > 1:
            source += f", {self.world} processes of {self.local_batch}"
        self.data_source = source
        self.metrics = None
        if is_main_process():
            # the JAX trainer's sink (maskdit_tpu/train/trainer.py:255-264):
            # JSONL, and wandb where it is asked for and importable
            wandb_cfg = config.get("wandb") or {}
            self.metrics = MetricLogger(
                self.exp_dir, use_wandb=use_wandb,
                wandb_kwargs={k: wandb_cfg.get(k) for k in ("entity", "project", "group")}
                if use_wandb else None,
                config=config,
            )
        self.peak_tflops = (
            peak_bf16_tflops(torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else None
        )
        self.history: list[dict[str, Any]] = []
        self._step_cache: dict[float, Any] = {}

    def lr_at(self, step: int) -> float:
        """The schedule's learning rate after ``step`` steps (train/lr)."""
        return self.optimizer.lr_at(step)

    def _mask_len_max(self) -> int:
        """The most tokens any value of the schedule keeps, probed on a
        progress grid (JAX trainer.py:279-286): the pad-to-max encoder's
        width."""
        min_ratio = min(float(self.mask_ratio_fn(i / 256.0)) for i in range(257))
        return max(1, len_keep_for(self.seq_len, min_ratio))

    def _step_for_ratio(self, ratio: float):
        key = "padded" if self.pad_to_max else bucket_ratio(ratio, self.seq_len)
        if key not in self._step_cache:
            m, t = self.config["model"], self.config["train"]
            self._step_cache[key] = make_train_step(
                self.optimizer,
                mask_ratio=0.5 if self.pad_to_max else key,  # padded: the batch's ratio
                mae_loss_coef=m["mae_loss_coef"],
                class_dropout_prob=m.get("class_dropout_prob", 0.1),
                ema_decay=t.get("ema_decay", 0.9999),
                grad_accum=self.grad_accum,
                ema_every=t.get("ema_every", 1),
                amp_grads=t.get("amp_grads", False),
                accum_dtype=t.get("accum_dtype"),
                sync=self.sync,
                pad_to_max=self.pad_to_max,
                mask_len_max=self._mask_len_max() if self.pad_to_max else None,
                debug_nans=self.debug_nans,
            )
        return self._step_cache[key]

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
        mprint(
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
        if self.metrics is not None:
            self.metrics.log(
                {f"train/{k}": v for k, v in record.items()
                 if k not in ("step", "losses") and v is not None},
                step,
            )

    def _save(self, step: int) -> None:
        """Rank 0 writes the checkpoint; every process waits for it."""
        if is_main_process():
            self.ckpt_mgr.save(step, self.state.checkpoint())
        barrier()

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
        mprint(f"training {self.exp_name}: global batch {self.global_batch}, "
               f"{self.data_source}, max {self.max_steps} steps, "
               f"device {self.device}", flush=True)
        try:
            for host_batch in prefetch(iter(self.loader)):
                # every process stops after the same step
                stopping = stop["flag"] if self.sync is None else self.sync.any(stop["flag"])
                if step >= self.start_step + self.max_steps or stopping:
                    break
                progress = (step - self.start_step) / max(self.max_steps, 1)
                ratio = float(self.mask_ratio_fn(progress))
                step_fn = self._step_for_ratio(ratio)
                generator.manual_seed(step_seed(self.seed + 1, step))
                if self.config["model"].get("ext_feature_dim", 0) == 0:
                    host_batch.pop("feat", None)  # JAX trainer.py:367-368
                batch = to_device(host_batch, self.device)
                if self.pad_to_max:
                    batch["mask_ratio"] = ratio  # the step's ratio rides the batch
                running.append(step_fn(self.state, batch, generator))
                step += 1
                throughput.update(1, self.global_batch)
                if step % log_every == 0:
                    self._log(step, running, ratio, throughput)
                    running = []
                    throughput.reset()
                if step % ckpt_every == 0:
                    self._save(step)
                    mprint(f"checkpoint saved at step {step}", flush=True)
                    if self.eval_hook is not None:
                        # every process samples its share of the seeds
                        eval_metrics = self.eval_hook(step, self.state.named(self.state.ema))
                        mprint(f"(step={step:07d}) eval: {eval_metrics}", flush=True)
                        if eval_metrics and self.metrics is not None:
                            self.metrics.log({f"eval/{k}": v for k, v in eval_metrics.items()},
                                             step)
                        throughput.reset()
            if running:
                self._log(step, running, ratio, throughput)
            unsaved = step not in self.ckpt_mgr.all_steps()
            if self.sync is not None:
                unsaved = self.sync.any(unsaved)  # rank 0's view, before it writes
            if unsaved:
                self._save(step)
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if self.metrics is not None:
                self.metrics.close()
        mprint(f"training done at step {step}", flush=True)
        return step
