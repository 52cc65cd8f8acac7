"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Every phase runs; each raises on failure:

  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the port's seven CUDA kernels from ops/csrc/, one nvcc
     per source, all started together, with their register and spill
     reports;
  3. kernel vs plain, each against its plain PyTorch version with both
     times, the time of one PyTorch library call for the same function and
     the least time the card could take (the bound): packed attention
     forward at the 256-px sampling and training shapes, its backward at
     the training shapes, both in bf16 and fp32; the fused Adam + EMA
     update over all of DiT-XL/2's parameters; the blocked attention
     forward and backward at the 512-px shapes, at a ragged shape and at
     the unmasked 256-px encoder's, where one attention layer's route is
     checked on the card; every bf16 tensor-core kernel (the whole-row
     forward #1, the blocked and flash forwards #3 and #5,
     csrc/attention_fwd_mma.cuh, both packed backwards #2 and #4,
     csrc/attention_bwd_mma.cuh, and the flash backward #6) at every head
     dim that is a multiple of 8 from 8 to 128; each row of #1, #2, #4 and
     #6 names the kernels that ran (mma or fma), and a bf16 one at such a
     head dim that is not mma fails;
  4. sampling at 256 px (the serving path): a random DiT-XL/2 (decoder,
     MAE coef 0.1, 1000 classes, every parameter ~ N(0, 0.02^2)) saved as a
     reference ``{"ema": ...}`` checkpoint; ``maskdit_tpu_torch.generate``
     with it (8 seeds, CFG 1.5, 40 EDM steps), checking the latents and that
     all 79 x 36 attention calls launched the packed kernel; model parity
     kernel vs plain in bf16 and fp32; warm images/s; a profile of one
     evaluation;
  5. sampling at 512 px: the same weights (one parameter set serves both
     resolutions) through the generate CLI on configs/test/maskdit-512.yaml
     (4 seeds, CFG 1.5, 40 steps, 64 x 64 latents), all 79 x 36 attention
     calls through the blocked kernel; model parity at 512; warm images/s;
     a profile of one evaluation;
  6. training at 256 px: ``maskdit_tpu_torch.train.main`` on the released
     256-px config at its batch of 128, cut to 12 steps, on [extract]'s
     latent LMDB (native reader); checks finite losses, 36 + 36 attention launches and one
     fused-update launch per step, and that resuming from the checkpoint
     restores it exactly; train-step parity kernels vs plain in fp32 and
     bf16; a profile of one train step;
  7. training at 512 px: the same CLI on the released 512-px config at its
     batch of 32, cut to 8 steps, on [extract]'s WebDataset shards
     (indexed), 36 + 36 blocked-attention launches and
     one fused-update launch per step; train-step parity; a profile;
  8. the ``use_flash`` path (ops/flash.py, kernels #5 and #6): both kernels
     against their plain versions at every L of their window (bf16, head
     dims 32, 64, 72), then timed at the 512-px shapes, at the edges of
     the window and at an odd head dim; one CFG denoiser evaluation at
     512 px with ``use_flash=True``, kernels vs plain; the train CLI on the
     released 512-px config with the overrides ``model.use_flash=true`` and
     ``data.streaming=true`` (the shards streamed), at batch 32, cut to 6
     steps: 72 flash-forward launches (the checkpoint
     recomputes each layer's forward in the backward), 36 flash-backward
     and one fused-update launch per step; train-step parity kernels vs
     plain and, in fp32, flash vs the blocked kernels; a profile;
  9. the evaluation path (it runs after 5.): [vae] the full SD-VAE
     (weights ~ N(0, 0.02^2), GroupNorm scales about 1, saved in the
     released autoencoder_kl.pth layout) decoding the latents of 4. and
     5. and encoding a 256-px batch, card vs CPU in fp32 with TF32 off (the
     CPU decodes the first images of each batch), ms per image against the
     fp32 bound, peak memory, and the decode with TF32 on measured once;
     [main-png] the generate CLI at 256 px without --no_decode (8 seeds,
     CFG 1.5, 40 steps, 2844 packed-kernel launches): 8 PNGs read back by
     the port's codec, images/s including the decode; [eval] ``fid ref``
     over those PNGs (random detector), ``eval_latent`` on
     configs/test/maskdit-256.yaml (as JSON) with 16 seeds to a finite FID
     against them, the detector card vs CPU, the evaluator CLI on two npz
     batches, InceptionV3 ms per image; [train-eval] 6. runs with
     ``--enable_eval``: after its last step's checkpoint the eval hook
     samples 8 seeds, decodes them and writes a finite eval/fid at step 12
     to metrics.jsonl;
 10. the data path (it runs after [vae], before 6.): [extract] 64 seeded
     PNGs (smooth content, 8 class folders, half about 400 x 300, half with
     a short side >= 512) through ``maskdit_tpu_torch.extract_latent
     --resolution 256 --xflip`` on the card with [vae]'s weights (128
     records), the first 16 at 512 px (32 records) and ``lmdb2wds
     --maxcount 8`` (4 shards): the native reader, the counts, the crop
     against a direct call, the first image's card moments against a CPU
     fp32 encode; encode ms per image against the fp32 bound, the host
     crop, the LMDB write rate, the loaders' batches/s against the
     synthetic dataset's;
 11. [overfit-gate] tools/torch_overfit_gate.py at its defaults (2000 fp32
     steps of a tiny DiT-S/2 on 8 latents through the port's Trainer, then
     sampled back): fails unless the verdict passes; its fp32 launches of
     the whole-row attention and the update count in the kernels line;
 12. the train-step options (after 6.): [kernel] fused adam in every
     variant of ADAM_VARIANTS (a bf16 gradient, bf16 mu and nu, the EMA
     off), the new ones bit for bit with the plain version (nu's
     stochastic rounding by Philox4x32-10 included), and the rounding's
     statistics over 2^20 values; [parity-train-options] one bf16 step
     with amp_grads, a bf16 accumulator over 2 micro-batches, bf16 mu and
     nu and ema_every 2, kernels vs plain (and kernel #7 bit for bit on the
     step's own gradient); [train-options] the train CLI with those
     options at a global batch of 2 x 64, 8 steps, 72 + 72 attention
     launches and one update per step, beside [train]'s times;
 13. data parallelism on the one card, each phase a ``torch.distributed.run``
     of this script's workers (``--worker TAG``): [parity-ddp] two gloo
     ranks, one fp32 step on an injected global batch of 32: the replicas
     equal bit for bit and within [parity-train]'s fp32 bounds of one
     process's step; [train-ddp] the train CLI in two gloo ranks sharing
     the card, 4 steps at a global batch of 64: finite losses, one log line
     per logged step (rank 0's), equal parameter digests; [train-ddp-nccl]
     one NCCL rank against the same 4 steps without a process group: equal
     bit for bit. These CLI runs write no checkpoint (a call may write 45
     GiB; [train] holds the writes and the resume).

Before each main path the launch counts are set to 0 and read just after:
a path fails if a kernel it should run was not launched, or one it should
not run was. The line before the last is a JSON object of the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")

# configs/train/imagenet256-latent.yaml as JSON (the card's machine need
# not have PyYAML), with data.root at [extract]'s latent LMDB (64 seeded
# PNGs and their flips: 128 records, one batch of 128 per epoch) and the
# cut TRAIN_CUTS lists: 12 steps, for the smoke's time; logged every 2
# steps so that the warm window leaves out the first two.
# tests/test_torch_trainer.py holds the rest equal to the YAML.
TRAIN_STEPS, TRAIN_BATCH, LOG_EVERY = 12, 128, 2
# the same for configs/train/imagenet512-latent.yaml: 8 steps at the
# released batch of 32, over [extract]'s 4 WebDataset shards (16 PNGs and
# their flips at 512 px); tests/test_torch_512.py holds it to the YAML
TRAIN_STEPS_512, TRAIN_BATCH_512 = 8, 32

# [extract]: seeded PNGs in an ImageFolder tree of EXTRACT_CLASSES class
# folders; the first EXTRACT_IMAGES_512 of them also at 512 px; the 512-px
# LMDB in shards of WDS_MAXCOUNT records
EXTRACT_IMAGES, EXTRACT_CLASSES, EXTRACT_IMAGES_512, WDS_MAXCOUNT = 64, 8, 16, 8
LATENT_ROOT = os.path.join(SCRATCH, "latents")
TRAIN_DATA_ROOT = os.path.join(LATENT_ROOT, "imagenet_256_latent_lmdb")
TRAIN_DATA_ROOT_512 = os.path.join(SCRATCH, "wds-512")
LOADER_BATCHES = 20  # batches timed per loader, after its first

SEEDS, STEPS, CFG = 8, 40, 1.5
SEEDS_512 = 4
DEPTH, DECODER_DEPTH = 28, 8

# (name, N, L, heads, head dim): the encoder and decoder blocks of the
# sampling path (CFG batch 2 x 8) and of the masked training path (the
# encoder at the 128 kept tokens)
ATTN_SHAPES = [
    ("encoder", 2 * SEEDS, 256, 16, 72),
    ("decoder", 2 * SEEDS, 256, 16, 32),
    ("train_encoder", TRAIN_BATCH, 128, 16, 72),
    ("train_decoder", TRAIN_BATCH, 256, 16, 32),
]
# the whole-row forward (#1) also at a ragged shape: L not a multiple of the
# 64-row tiles, hd 40
ATTN_FWD_SHAPES = ATTN_SHAPES + [("ragged", 3, 77, 4, 40)]
# kernel vs plain bound on max|kernel - plain| / max|plain| of the forward:
# fp32 differs only by summation order; bf16 where that order flips one
# rounding of p or of the output, by one bf16 ulp, at most 2^-7 of the
# largest value
FWD_REL_BOUND = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# and in bf16 the share of elements (forward or backward) that differ at all:
# another summation order flips few (under 0.5% for fp64 sums), while a
# rounding point moved or dropped (p rounded before normalising, or not at
# all; ds unrounded) changes over 20% of them at the same max error
# (tests/test_torch_flash_big.py holds both)
BF16_MISMATCH_BOUND = 0.05
# whole-model bound on max|kernel - plain| / max|plain| of D(x; sigma)
MODEL_REL_BOUND = {torch.bfloat16: 5e-2, torch.float32: 1e-4}

# the backward at the training path's shapes: encoder L128 hd72, decoder
# L256 hd32. Bound on max|kernel - plain| / max|plain|: fp32 sums
# in another order; bf16 may round ds, pb or the output one ulp (2^-8)
# the other way where the fp32 values differ in their last bits
# (and a ragged one: L not a multiple of the 32-row blocks, hd of 40);
# BF16_MISMATCH_BOUND holds too
BWD_SHAPES = [("train_encoder", TRAIN_BATCH, 128, 16, 72),
              ("train_decoder", TRAIN_BATCH, 256, 16, 32), ("ragged", 3, 77, 4, 40)]
BWD_REL_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-5}

# the blocked kernels at the 512-px paths' shapes: sampling (CFG batch
# 2 x 4, encoder and decoder at L 1024) and training (batch 32, the encoder
# at the 512 kept tokens, the decoder at L 1024); and XL/2's encoder trained
# unmasked at 256 px (configs/finetune/imagenet256-latent-const.yaml, batch
# 64, L 256), where the whole-row backward does not fit and the route takes
# these kernels. The backward at the training shapes and a ragged one (L not
# a multiple of the 32-row blocks or the 64-row tiles, hd 40). The bounds
# are FWD_REL_BOUND and BWD_REL_BOUND.
UNMASKED_256 = ("unmasked256_encoder", 64, 256, 16, 72)
BIG_SHAPES = [
    ("sample_encoder", 2 * SEEDS_512, 1024, 16, 72),
    ("sample_decoder", 2 * SEEDS_512, 1024, 16, 32),
    ("train_encoder", TRAIN_BATCH_512, 512, 16, 72),
    ("train_decoder", TRAIN_BATCH_512, 1024, 16, 32),
    UNMASKED_256,
]
RAGGED_BIG = ("ragged", 3, 777, 4, 40)
BIG_FWD_SHAPES = BIG_SHAPES + [RAGGED_BIG]
BIG_BWD_SHAPES = BIG_SHAPES[2:] + [RAGGED_BIG]
# both bf16 forwards (#3, #5: one tensor-core kernel, two layouts) and both
# bf16 backwards (#2, #4: one pair of tensor-core kernels) at every head dim
# that is a multiple of 8 up to 128: the odd multiples of 8 take the padding
# of hd to a multiple of 16 in Q.K^T (and dO.V^T) and an odd count of 8-wide
# n-tiles in P.V (and dS.K, P^T.dO, dS^T.Q); (N, L, H) = SWEEP_SHAPE, L a
# multiple of the flash window
SWEEP_SHAPE = (2, 384, 4)
SWEEP_HEAD_DIMS = range(8, 129, 8)
# the whole-row forward (#1) over the same head dims at an L its route takes
# at every one of them
PACKED_SWEEP_SHAPE = (2, 128, 4)

# ops/flash.py's kernels (#5, #6) at the use_flash path's 512-px shapes
# (sampling: CFG batch 2 x 4 at L 1024; training: batch 32, the encoder at
# the 512 kept tokens, the decoder at L 1024), at the edges of the kernels'
# window (L 128 and 2048; 2048 takes the 16-row forward blocks) and at an
# odd head dim; the backward at the training shapes, L 2048 and hd 40. The
# bounds are FWD_REL_BOUND, BWD_REL_BOUND and BF16_MISMATCH_BOUND; the fp32
# logsumexp is held to LSE_REL_BOUND x max|lse| (fp32 sums in another order)
FLASH_SHAPES = BIG_SHAPES[:4] + [("edge_128", 128, 128, 16, 72), ("edge_2048", 2, 2048, 16, 72),
                                 ("hd40", 3, 384, 4, 40)]
FLASH_BWD_SHAPES = FLASH_SHAPES[2:4] + FLASH_SHAPES[5:]
LSE_REL_BOUND = 1e-5
TRAIN_STEPS_FLASH = 6

# fused Adam: fp32 everywhere, the two differ by FMA contraction only, so
# per element |kernel - plain| <= 1e-6 |plain| + 1e-7; a bf16 mu by at most
# one bf16 ulp (2^-7 of the value) where that contraction flips a rounding
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
# operations per parameter of the update (fused_adam_ema.cu's update():
# m 3, v 4, the denominator 3, p 4, the EMA 3)
ADAM_OPS = 17
# the kernel's variants, (g, mu, nu, EMA): the first two (fp32 g and nu,
# the EMA on) keep their FMA contraction and are held to the bound above;
# every other one computes with the plain version's roundings and is held
# to it bit for bit, nu's stochastic rounding included. Which path runs
# each: [train] / the gate, moment_dtype, amp_grads, nu_dtype, the
# [train-options] steps with and without the EMA, ema_every alone
ADAM_VARIANTS = [
    (torch.float32, torch.float32, torch.float32, True),
    (torch.float32, torch.bfloat16, torch.float32, True),
    (torch.bfloat16, torch.float32, torch.float32, True),
    (torch.float32, torch.float32, torch.bfloat16, True),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, False),
    (torch.float32, torch.float32, torch.float32, False),
]
# stochastic rounding on the card: over SR_VALUES copies of a value a
# fraction f of a bf16 gap above 1.0, the mean is within 2% of a gap
SR_VALUES = 1 << 20

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# bf16 on the tensor cores, fp32 outside them, and HBM3's rate. A bound is
# the larger of operations over the peak of the inputs' type and bytes
# (each input read once, each output written once) over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

TRAIN_CONFIG = {
    "data": {"dataset": "imagenet256-latent", "category": "lmdb", "resolution": 32,
             "num_channels": 4, "random_flip": True, "root": TRAIN_DATA_ROOT,
             "feat_path": "None"},
    "model": {"precond": "edm", "model_type": "DiT-XL/2", "in_size": 32, "in_channels": 4,
              "num_classes": 1000, "use_decoder": True, "ext_feature_dim": 0,
              "pad_cls_token": False, "mask_ratio": 0.5, "mask_ratio_fn": "constant",
              "mask_ratio_min": 0, "mae_loss_coef": 0.1, "class_dropout_prob": 0.1},
    "train": {"fp32": False, "batchsize": TRAIN_BATCH, "grad_accum": 1, "amp_grads": False,
              "accum_dtype": None, "moment_dtype": None, "epochs": 2800, "lr": 0.0001,
              "lr_rampup_kimg": 0, "xflip": False, "max_num_steps": TRAIN_STEPS},
    "log": {"log_every": LOG_EVERY, "ckpt_every": 50000, "tag": "chip-smoke"},
}
TRAIN_CUTS = {"train.max_num_steps": (2000000, TRAIN_STEPS)}
# [train-options]: TRAIN_CONFIG with every train-step option of the JAX
# trainer on: bf16 gradients, a bf16 accumulator over 2 micro-batches of 64
# (the global batch of 128 as [train]'s), bf16 mu and nu (stochastically
# rounded), the EMA every 2nd step with decay^2. use_flash null keeps the
# packed kernels (default_use_flash picks the plain attention for
# accumulation at L < 512: ROADMAP.md C2)
TRAIN_OPTIONS_STEPS, TRAIN_OPTIONS_MICRO, TRAIN_OPTIONS_ACCUM = 8, 64, 2
TRAIN_OPTIONS = (
    f"train.batchsize={TRAIN_OPTIONS_MICRO}", f"train.grad_accum={TRAIN_OPTIONS_ACCUM}",
    "train.amp_grads=true", "train.accum_dtype=bfloat16", "train.moment_dtype=bfloat16",
    "train.nu_dtype=bfloat16", "train.ema_every=2", "model.use_flash=null",
    f"train.max_num_steps={TRAIN_OPTIONS_STEPS}",
)
# data parallelism on the one card: two ranks share it over gloo (NCCL
# refuses two ranks on one device), the NCCL path runs with one rank.
# [parity-ddp]: one fp32 step on an injected global batch; [train-ddp] and
# [train-ddp-nccl]: the train CLI for DDP_STEPS steps at a global batch of
# DDP_BATCH
PARITY_DDP_BATCH, DDP_STEPS, DDP_BATCH = 32, 4, 64
DDP_OVERRIDES = (f"train.max_num_steps={DDP_STEPS}",)
WORKER_TIMEOUT = 300
TRAIN_CONFIG_512 = {
    "data": {"dataset": "imagenet512-latent", "category": "webdataset", "resolution": 64,
             "num_channels": 4, "root": TRAIN_DATA_ROOT_512, "total_num": 1281167,
             "streaming": False, "shuffle_buffer": 1000},
    "model": {**TRAIN_CONFIG["model"], "in_size": 64},
    "train": {**TRAIN_CONFIG["train"], "batchsize": TRAIN_BATCH_512, "epochs": 2000,
              "max_num_steps": TRAIN_STEPS_512},
    "log": {"log_every": LOG_EVERY, "ckpt_every": 50000, "tag": "chip-smoke-512"},
}
TRAIN_CUTS_512 = {"train.max_num_steps": (2000000, TRAIN_STEPS_512)}
# configs/test/maskdit-512.yaml's model section (what the generate CLI
# reads), as JSON; tests/test_torch_512.py holds it equal to the YAML
SAMPLE_CONFIG_512 = {"model": {
    "precond": "edm", "model_type": "DiT-XL/2", "in_size": 64, "in_channels": 4,
    "num_classes": 1000, "use_decoder": True, "ext_feature_dim": 0, "pad_cls_token": False,
    "mask_ratio": 0.5, "mae_loss_coef": 0.1, "class_dropout_prob": 0.1,
}}
# configs/test/maskdit-256.yaml's model and eval sections (what the eval
# CLI reads), as JSON; phase_eval points eval.ref_path at the statistics of
# [main-png]'s PNGs (ImageNet's are not in the repository).
# tests/test_torch_evals.py holds it equal to the YAML
EVAL_CONFIG_256 = {"model": {**SAMPLE_CONFIG_512["model"], "in_size": 32},
                   "eval": {"batchsize": 50, "ref_path": (
                       "assets/fid_stats/fid_stats_imagenet256_guided_diffusion.npz")}}
EVAL_SEEDS = 16  # two batches of SEEDS
# the card decodes [main]'s and [main-512]'s whole batches; the CPU's fp32
# reference decodes their first images only (each image is decoded on its
# own: GroupNorm and the attention are per image), 2.5 s per 256-px image
VAE_CPU_IMAGES = {256: 2, 512: 1}
# the evaluation path: card vs CPU in fp32 with TF32 off on both (cuDNN's and
# oneDNN's summation orders; measured ~1e-6 on the CPU against the JAX
# package), as max error relative to max|ref|
VAE_REL_BOUND = 1e-4
INCEPTION_REL_BOUND = 1e-4
INCEPTION_BATCH = 64  # the FID CLIs' default batch
# attention calls per train step (28 encoder + 8 decoder blocks), each
# once forward and once backward; one fused update per step
ATTN_PER_STEP = DEPTH + DECODER_DEPTH
ADAM_PER_STEP = 1
# train-step parity, kernels vs plain, from one state and draws, at batch
# 8 (256 px) and 4 (512 px): fp32 with TF32 off: sums in other orders;
# bf16: the attention kernels round probabilities, ds and outputs at the
# same points as the plain versions, but a last-bit fp32 difference can
# flip one bf16 rounding, which 36 layers and the backward carry into
# every gradient
PARITY_BATCH, PARITY_BATCH_512 = 8, 4
TRAIN_PARITY_BOUND = {
    torch.float32: dict(loss=1e-5, grad=1e-4, state=1e-5),
    torch.bfloat16: dict(loss=1e-2, grad=1e-1, state=1e-2),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the device, from CUDA events."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def free_device_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def bound(flops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least milliseconds the card could take, and what sets it."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def attention_bound(n: int, l: int, h: int, hd: int, dtype: torch.dtype, products: int,
                    planes: int, rows_fp32: int = 0) -> tuple[float, str]:
    """The TPU kernel's ``products`` L x L x hd products per head, 2 N H L^2
    hd operations each, and the bytes of its inputs and outputs: ``planes``
    multiples of (N, L, D) in the input type and ``rows_fp32`` of (N, H, L)
    in fp32 (the logsumexp). #1-#4: 2 products (s, o) and 4 planes (qkv,
    out) forward, 6 (s, o, dv, dp, dq, dk) and 7 (qkv, dout, dqkv)
    backward; #5: 2 and 4 (q, k, v, o) + lse; #6: 5 (s, dv, dp, dq, dk) and
    8 (q, k, v, o, do, dq, dk, dv) + lse."""
    es = torch.empty((), dtype=dtype).element_size()
    return bound(2 * products * n * h * l * l * hd,
                 planes * n * l * h * hd * es + rows_fp32 * n * h * l * 4, dtype)


def library_attention_ms(qkv: torch.Tensor, h: int, scale: float, iters: int,
                         dout: torch.Tensor | None = None) -> float:
    """One PyTorch call for the same function, as a yardstick only:
    ``F.scaled_dot_product_attention`` on q, k, v (N, H, L, hd); with
    ``dout``, its forward and backward."""
    n, l, three_d = qkv.shape
    hd = three_d // 3 // h
    q, k, v = (t.contiguous() for t in qkv.reshape(n, l, 3, h, hd).permute(2, 0, 3, 1, 4))
    g = None if dout is None else dout.reshape(n, l, h, hd).permute(0, 2, 1, 3).contiguous()
    return sdpa_ms(q, k, v, scale, iters, g)


def sdpa_ms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, iters: int,
            g: torch.Tensor | None = None) -> float:
    """``F.scaled_dot_product_attention`` on q, k, v (N, H, L, hd); with the
    output's gradient ``g``, its forward and backward."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    if g is None:
        with torch.no_grad():
            return cuda_ms(lambda: sdpa(q, k, v, scale=scale), iters)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))

    def forward_backward():
        sdpa(q, k, v, scale=scale).backward(g)
        q.grad = k.grad = v.grad = None

    return cuda_ms(forward_backward, iters)


def kernel_counters() -> dict:
    """Each kernel's wrapper, which counts its launches."""
    from maskdit_tpu_torch.ops import flash, flash_batched, flash_big, fused_adam

    return {"packed_fwd": flash_batched.packed_attention,
            "packed_bwd": flash_batched.packed_attention_bwd,
            "big_fwd": flash_big.packed_attention_big,
            "big_bwd": flash_big.packed_attention_big_bwd,
            "flash_fwd": flash.flash_fwd,
            "flash_bwd": flash.flash_bwd,
            "adam": fused_adam.fused_adam_ema}


def reset_launches() -> None:
    for wrapper in kernel_counters().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in kernel_counters().items()}


def expect_launches(tag: str, launches: dict, **expected) -> None:
    """The main path launched exactly the kernels it should, and no other."""
    want = {name: expected.get(name, 0) for name in kernel_counters()}
    log(f"[{tag}] launches {launches} (expected {want})")
    if launches != want or not any(want.values()):
        raise AssertionError(f"{tag}: launches {launches} != {want}")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from maskdit_tpu_torch.ops import build, flash, flash_batched, flash_big, fused_adam

    names = [flash_batched.KERNEL, flash_batched.BWD_KERNEL, fused_adam.KERNEL,
             flash_big.KERNEL, flash_big.BWD_KERNEL, flash.KERNEL, flash.BWD_KERNEL]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build.build, names))
    log(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for lib, seconds in built:
        log(f"[build] {lib.name} in {seconds:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "stack frame")):
                log(f"[build]   {line.strip()}")


def check_smem_formulas() -> None:
    """The routing rule reads shared-memory sizes from Python formulas;
    they must be the kernel libraries' own."""
    from maskdit_tpu_torch.ops import flash, flash_batched, flash_big

    fwd, bwd = flash_batched._library(), flash_batched._bwd_library()
    big, big_bwd = flash_big._library(), flash_big._bwd_library()
    fl, fl_bwd = flash._library(), flash._bwd_library()
    # (896, 8) and (896, 16): bf16 past the whole-row tensor-core forward's
    # limit, where the FMA kernel's layout holds
    for l, hd in ((77, 40), (128, 72), (256, 72), (256, 32), (512, 72), (777, 40), (896, 8),
                  (896, 16), (1024, 32), (1024, 72), (1024, 128)):
        for es in (2, 4):
            assert fwd.packed_attention_fwd_smem_bytes(l, hd, es) == \
                flash_batched.fwd_smem_bytes(l, hd, es), (l, hd, es)
            assert big.packed_attention_big_fwd_smem_bytes(l, hd, es) == \
                flash_big.fwd_smem_bytes(l, hd, es), (l, hd, es)
            assert bwd.packed_attention_bwd_smem_bytes(l, hd, es) == \
                flash_batched.bwd_smem_bytes(l, hd, es), (l, hd, es)
            assert big_bwd.packed_attention_big_bwd_smem_bytes(l, hd, es) == \
                flash_big.bwd_smem_bytes(l, hd, es), (l, hd, es)
        for rows in flash.BLOCK_ROWS:
            assert fl.flash_fwd_smem_bytes(l, hd, rows, 4) == \
                flash.fwd_smem_bytes(l, hd, rows, 4), (l, hd, rows)
        assert fl.flash_fwd_smem_bytes(l, hd, flash.MMA_ROWS, 2) == \
            flash.fwd_smem_bytes(l, hd, flash.MMA_ROWS, 2), (l, hd)
        for es in (2, 4):
            assert fl_bwd.flash_bwd_smem_bytes(hd, es) == flash.bwd_smem_bytes(hd, es), (hd, es)
    for l in (1408, 1536, 2048):  # where the flash forward's 32-row fp32 blocks stop fitting
        for rows in flash.BLOCK_ROWS:
            assert fl.flash_fwd_smem_bytes(l, 72, rows, 4) == flash.fwd_smem_bytes(l, 72, rows, 4)
        assert fl.flash_fwd_smem_bytes(l, 72, flash.MMA_ROWS, 2) == \
            flash.fwd_smem_bytes(l, 72, flash.MMA_ROWS, 2)
    for hd in SWEEP_HEAD_DIMS:  # the tensor-core forward's and backward's, per head dim
        assert big.packed_attention_big_fwd_smem_bytes(2048, hd, 2) == \
            fl.flash_fwd_smem_bytes(2048, hd, flash.MMA_ROWS, 2) == \
            flash_big.mma_fwd_smem_bytes(hd), hd
        assert bwd.packed_attention_bwd_smem_bytes(2048, hd, 2) == \
            big_bwd.packed_attention_big_bwd_smem_bytes(2048, hd, 2) == \
            flash_batched.mma_bwd_smem_bytes(hd), hd
        assert fl_bwd.flash_bwd_smem_bytes(hd, 2) == flash.bwd_smem_bytes(hd, 2), hd
        # the whole-row forward (#1): the tensor-core kernel at every L of
        # the route up to 832, and its layout where it runs
        for l in (77, 128, 256, 384, 600, 832):
            assert fwd.packed_attention_fwd_smem_bytes(l, hd, 2) == \
                flash_batched.fwd_smem_bytes(l, hd, 2), (l, hd)
            if flash_batched.fits(l, hd, False):
                assert flash_batched.fwd_kernel(torch.bfloat16, l, hd) == "mma", (l, hd)
                assert fwd.packed_attention_fwd_smem_bytes(l, hd, 2) == \
                    flash_batched.mma_fwd_smem_bytes(l, hd), (l, hd)
    log("[kernel] the routing rule's shared-memory formulas equal the libraries' at 11 shapes "
        "in bf16 and fp32, the flash forward's at 14, the tensor-core kernels' (the blocked "
        "forward, both packed backwards, the flash backward, the whole-row forward at 6 L) "
        "at 16 head dims")


def compare(got: torch.Tensor, ref: torch.Tensor, rel_bound: float,
            dtype: torch.dtype) -> tuple[float, float, float, bool]:
    """max|got - ref|, its bound rel_bound * max|ref|, the share of
    elements that differ, and whether all holds (the share only in bf16)."""
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    bnd = rel_bound * ref.float().abs().max().item()
    share = (diff > 0).float().mean().item()
    ok = bool(np.isfinite(err) and err <= bnd
              and (dtype != torch.bfloat16 or share <= BF16_MISMATCH_BOUND))
    return err, bnd, share, ok


def check_variant(what: str, dtype: torch.dtype, hd: int, variant: str) -> None:
    """A bf16 call at a head dim that is a multiple of 8 runs the
    tensor-core kernels ('mma'), never the FMA ones."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and variant != "mma":
        raise AssertionError(f"{what}: bf16 at hd {hd} ran the {variant} kernel, not mma")


def attention_fwd_rows(tag: str, shapes, kernel, plain, seed: int, iters: int,
                       variant=None) -> dict:
    """The forward wrapper ``kernel`` against ``plain`` at each shape and
    type: error, kernel, plain and library times, bound. ``variant(dtype,
    L, hd)``, where given, names the kernel that ran (mma or fma)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, n, l, h, hd in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            with torch.no_grad():
                before = kernel.launches
                out = kernel(qkv, h, scale)
                torch.cuda.synchronize()
                launches = kernel.launches - before
                ref = plain(qkv, h, scale)
                err, bnd, share, ok = compare(out, ref, FWD_REL_BOUND[dtype], dtype)
                del out, ref
                ms = cuda_ms(lambda: kernel(qkv, h, scale), iters)
                plain_ms = cuda_ms(lambda: plain(qkv, h, scale), iters)
            library_ms = library_attention_ms(qkv, h, scale, iters)
            bound_ms, bound_by = attention_bound(n, l, h, hd, dtype, 2, 4)
            dt = dtype_name(dtype)
            ran = ""
            if variant is not None:
                ran = f" ({variant(dtype, l, hd)})"
                check_variant(f"{tag} {name}", dtype, hd, variant(dtype, l, hd))
            log(f"[{tag}] {name} N={n} L={l} H={h} hd={hd} {dt}{ran}: max_abs_err {err:.3e} "
                f"(bound {bnd:.3e} = {FWD_REL_BOUND[dtype]:.0e} x max|ref|), elements "
                f"differing {share:.5f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library (SDPA) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.3f} of it")
            if not (ok and launches == 1):
                raise AssertionError(f"{tag} {name} {dt}: err {err} > {bnd}, share {share} "
                                     f"or {launches} launches")
            results[(name, dt)] = dict(err=err, share=share, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
            del qkv
    free_device_memory()
    return results


def attention_bwd_rows(tag: str, shapes, kernel, plain, seed: int, iters: int) -> dict:
    """The backward wrapper ``kernel`` against ``plain``, as above; the
    library time is SDPA's forward and backward. Each row names the kernels
    that ran: 'mma' (bf16, csrc/attention_bwd_mma.cuh) or 'fma'."""
    from maskdit_tpu_torch.ops.flash_batched import bwd_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, n, l, h, hd in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, l, h * hd, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            before = kernel.launches
            got = kernel(qkv, dout, h, scale)
            torch.cuda.synchronize()
            launches = kernel.launches - before
            ref = plain(qkv, dout, h, scale)
            err, bnd, share, ok = compare(got, ref, BWD_REL_BOUND[dtype], dtype)
            del got, ref
            ms = cuda_ms(lambda: kernel(qkv, dout, h, scale), iters)
            plain_ms = cuda_ms(lambda: plain(qkv, dout, h, scale), iters)
            library_ms = library_attention_ms(qkv, h, scale, iters, dout)
            bound_ms, bound_by = attention_bound(n, l, h, hd, dtype, 6, 7)
            dt = dtype_name(dtype)
            check_variant(f"{tag} bwd {name}", dtype, hd, bwd_kernel(dtype, hd))
            log(f"[{tag}] attention bwd {name} N={n} L={l} H={h} hd={hd} {dt} "
                f"({bwd_kernel(dtype, hd)}): "
                f"max_abs_err {err:.3e} (bound {bnd:.3e} = {BWD_REL_BOUND[dtype]:.0e} "
                f"x max|ref|), elements differing {share:.5f}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library (SDPA fwd + bwd) {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it; launches per "
                f"call {launches}")
            if not (ok and launches == 1):
                raise AssertionError(f"{tag} bwd {name} {dt}: err {err} > {bnd}, share {share} "
                                     f"or {launches} launches")
            results[(name, dt)] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
            del qkv, dout
    free_device_memory()
    return results


def check_packed_fwd_head_dims() -> None:
    """The bf16 whole-row forward (#1) on the tensor cores launches once per
    call and agrees with its plain version at every head dim of
    SWEEP_HEAD_DIMS, at PACKED_SWEEP_SHAPE: FWD_REL_BOUND and
    BF16_MISMATCH_BOUND."""
    from maskdit_tpu_torch.ops import flash_batched

    g = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    n, l, h = PACKED_SWEEP_SHAPE
    kernel = flash_batched.packed_attention
    worst, worst_share = 0.0, 0.0
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        check_variant(f"whole-row forward hd sweep hd={hd}", bf16, hd,
                      flash_batched.fwd_kernel(bf16, l, hd))
        qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(bf16)
        before = kernel.launches
        with torch.no_grad():
            got = kernel(qkv, h, scale)
        torch.cuda.synchronize()
        launches = kernel.launches - before
        err, bnd, share, ok = compare(got, flash_batched.packed_attention_reference(qkv, h, scale),
                                      FWD_REL_BOUND[bf16], bf16)
        if not (ok and launches == 1):
            raise AssertionError(f"whole-row forward hd sweep hd={hd}: err {err} > {bnd}, share "
                                 f"{share} or {launches} launches")
        worst, worst_share = max(worst, err / bnd), max(worst_share, share)
    log(f"[kernel] head dims: the bf16 whole-row forward (#1, mma) at (N, L, H) = "
        f"{PACKED_SWEEP_SHAPE}, hd {SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step "
        f"{SWEEP_HEAD_DIMS.step}: {len(SWEEP_HEAD_DIMS)} rows within their bounds; the worst "
        f"error {worst:.3f} of its bound, the largest share of differing elements "
        f"{worst_share:.5f}")


def phase_kernels() -> dict:
    from maskdit_tpu_torch.ops import flash_batched

    check_smem_formulas()
    check_packed_fwd_head_dims()
    return attention_fwd_rows("kernel", ATTN_FWD_SHAPES, flash_batched.packed_attention,
                              flash_batched.packed_attention_reference, seed=0, iters=50,
                              variant=flash_batched.fwd_kernel)


def phase_bwd_kernels() -> dict:
    from maskdit_tpu_torch.ops import flash_batched

    return attention_bwd_rows("kernel", BWD_SHAPES, flash_batched.packed_attention_bwd,
                              flash_batched.packed_attention_bwd_reference, seed=1, iters=20)


def check_unmasked_256_route() -> None:
    """One XL/2 attention layer at the unmasked 256-px shape (batch 2, L 256,
    hd 72) on the card: with a backward it launches the blocked kernels, and
    no plain attention runs; without one, the whole-row forward."""
    from maskdit_tpu_torch.models.layers import Attention

    attn = Attention(16 * 72, 16, dtype=torch.bfloat16).cuda()
    x = torch.randn(2, 256, 16 * 72, device="cuda", requires_grad=True)
    reset_launches()
    attn(x).float().square().sum().backward()
    torch.cuda.synchronize()
    expect_launches("kernel-big", read_launches(), big_fwd=1, big_bwd=1)
    reset_launches()
    with torch.no_grad():
        attn(x)
    torch.cuda.synchronize()
    expect_launches("kernel-big", read_launches(), packed_fwd=1)
    del attn, x


def phase_big_kernels() -> dict:
    """The blocked kernels (kernels #3 and #4) at the 512-px shapes and at
    the unmasked 256-px encoder's; that shape's route on the card; both bf16
    backwards over the head dims."""
    from maskdit_tpu_torch.ops import flash_big

    check_unmasked_256_route()
    check_bwd_head_dims()

    fwd = attention_fwd_rows("kernel-big", BIG_FWD_SHAPES, flash_big.packed_attention_big,
                             flash_big.packed_attention_big_reference, seed=5, iters=10)
    bwd = attention_bwd_rows("kernel-big", BIG_BWD_SHAPES, flash_big.packed_attention_big_bwd,
                             flash_big.packed_attention_big_bwd_reference, seed=6, iters=5)
    return dict(fwd=fwd, bwd=bwd)


def flash_fwd_row(name: str, n: int, l: int, h: int, hd: int, dtype: torch.dtype,
                  g: torch.Generator, iters: int) -> dict:
    """The flash forward kernel against its plain version at one shape."""
    from maskdit_tpu_torch.ops import flash

    q, k, v = (torch.randn(n * h, l, hd, generator=g, device="cuda").to(dtype) for _ in range(3))
    scale = hd ** -0.5
    before = flash.flash_fwd.launches
    o, lse = flash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    launches = flash.flash_fwd.launches - before
    ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
    err, bnd, share, ok = compare(o, ref_o, FWD_REL_BOUND[dtype], dtype)
    lse_err = (lse - ref_lse).abs().max().item()
    lse_bnd = LSE_REL_BOUND * ref_lse.abs().max().item()
    del o, lse, ref_o, ref_lse
    ms = cuda_ms(lambda: flash.flash_fwd(q, k, v, scale), iters)
    plain_ms = cuda_ms(lambda: flash.flash_fwd_reference(q, k, v, scale), iters)
    library_ms = sdpa_ms(*(t.view(n, h, l, hd) for t in (q, k, v)), scale, iters)
    bound_ms, bound_by = attention_bound(n, l, h, hd, dtype, 2, 4, 1)
    dt = dtype_name(dtype)
    log(f"[kernel-flash] fwd {name} N={n} L={l} H={h} hd={hd} {dt}: max_abs_err {err:.3e} "
        f"(bound {bnd:.3e} = {FWD_REL_BOUND[dtype]:.0e} x max|ref|), elements differing "
        f"{share:.5f}, lse err {lse_err:.3e} (bound {lse_bnd:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / ms:.3f} of it")
    if not (ok and lse_err <= lse_bnd and launches == 1):
        raise AssertionError(f"flash fwd {name} {dt}: err {err} > {bnd}, share {share}, lse "
                             f"{lse_err} > {lse_bnd} or {launches} launches")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flash_bwd_row(name: str, n: int, l: int, h: int, hd: int, dtype: torch.dtype,
                  g: torch.Generator, iters: int) -> dict:
    """The flash backward kernel against its plain version at one shape, on
    the forward kernel's residuals; the library time is SDPA's forward and
    backward."""
    from maskdit_tpu_torch.ops import flash

    q, k, v, do = (torch.randn(n * h, l, hd, generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    scale = hd ** -0.5
    o, lse = flash.flash_fwd(q, k, v, scale)
    before = flash.flash_bwd.launches
    got = flash.flash_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    launches = flash.flash_bwd.launches - before
    ref = flash.flash_bwd_reference(q, k, v, o, lse, do, scale)
    checks = [compare(a, b, BWD_REL_BOUND[dtype], dtype) for a, b in zip(got, ref)]
    del got, ref
    err = max(c[0] for c in checks)
    share = max(c[2] for c in checks)
    ok = all(c[3] for c in checks)
    ms = cuda_ms(lambda: flash.flash_bwd(q, k, v, o, lse, do, scale), iters)
    plain_ms = cuda_ms(lambda: flash.flash_bwd_reference(q, k, v, o, lse, do, scale), iters)
    library_ms = sdpa_ms(*(t.view(n, h, l, hd) for t in (q, k, v)), scale, iters,
                         do.view(n, h, l, hd))
    bound_ms, bound_by = attention_bound(n, l, h, hd, dtype, 5, 8, 1)
    dt = dtype_name(dtype)
    check_variant(f"flash bwd {name}", dtype, hd, flash.bwd_kernel(dtype))
    log(f"[kernel-flash] bwd {name} N={n} L={l} H={h} hd={hd} {dt} ({flash.bwd_kernel(dtype)}): "
        f"dq/dk/dv max_abs_err "
        f"{'/'.join(f'{c[0]:.3e}' for c in checks)} (bounds "
        f"{'/'.join(f'{c[1]:.3e}' for c in checks)} = {BWD_REL_BOUND[dtype]:.0e} x max|ref|), "
        f"elements differing {'/'.join(f'{c[2]:.5f}' for c in checks)}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (SDPA fwd + bwd) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it")
    if not (ok and launches == 1):
        raise AssertionError(f"flash bwd {name} {dt}: checks {checks} or {launches} launches")
    return dict(err=err, share=share, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_flash_window() -> None:
    """Both flash kernels launch and agree with their plain versions (o,
    lse, dq, dk, dv) at every L of their window, 128 to 2048 in steps of
    128, at the model head dims 32, 64 and 72, in bf16 (N*H = 2)."""
    from maskdit_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(8)
    bf16 = torch.bfloat16
    worst, worst_share, shapes = 0.0, 0.0, 0
    for hd in (32, 64, 72):
        for l in range(flash.LANE, flash.MAX_L + 1, flash.LANE):
            q, k, v, do = (torch.randn(2, l, hd, generator=g, device="cuda").to(bf16)
                           for _ in range(4))
            scale = hd ** -0.5
            o, lse = flash.flash_fwd(q, k, v, scale)
            grads = flash.flash_bwd(q, k, v, o, lse, do, scale)
            ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
            ref_grads = flash.flash_bwd_reference(q, k, v, o, lse, do, scale)
            pairs = [(o, ref_o, FWD_REL_BOUND[bf16])] + [
                (a, b, BWD_REL_BOUND[bf16]) for a, b in zip(grads, ref_grads)]
            for got, ref, rel in pairs:
                err, bnd, share, ok = compare(got, ref, rel, bf16)
                if not ok:
                    raise AssertionError(f"flash window L={l} hd={hd}: err {err} > {bnd} "
                                         f"or share {share}")
                worst, worst_share = max(worst, err / bnd), max(worst_share, share)
            lse_err = (lse - ref_lse).abs().max().item()
            if lse_err > LSE_REL_BOUND * ref_lse.abs().max().item():
                raise AssertionError(f"flash window L={l} hd={hd}: lse err {lse_err}")
            shapes += 1
    log(f"[kernel-flash] window: fwd and bwd at every L of 128-2048 (step 128) x hd 32, 64, "
        f"72, bf16, N*H 2: {shapes} shapes within their bounds; the worst error "
        f"{worst:.3f} of its bound, the largest share of differing elements {worst_share:.5f}")


def check_fwd_head_dims() -> None:
    """Both bf16 forwards on the tensor cores (#3 packed, #5 separate heads)
    launch and agree with their plain versions at every head dim of
    SWEEP_HEAD_DIMS, at SWEEP_SHAPE: FWD_REL_BOUND and BF16_MISMATCH_BOUND,
    and for #5 the lse within LSE_REL_BOUND."""
    from maskdit_tpu_torch.ops import flash, flash_big

    g = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16
    n, l, h = SWEEP_SHAPE
    worst, worst_share, worst_lse = 0.0, 0.0, 0.0
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(bf16)
        before = flash_big.packed_attention_big.launches, flash.flash_fwd.launches
        with torch.no_grad():
            out = flash_big.packed_attention_big(qkv, h, scale)
        q, k, v = (t.reshape(n * h, l, hd).contiguous()
                   for t in qkv.reshape(n, l, 3, h, hd).permute(2, 0, 3, 1, 4))
        o, lse = flash.flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        launches = (flash_big.packed_attention_big.launches - before[0],
                    flash.flash_fwd.launches - before[1])
        ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
        pairs = ((out, flash_big.packed_attention_big_reference(qkv, h, scale)), (o, ref_o))
        for got, ref in pairs:
            err, bnd, share, ok = compare(got, ref, FWD_REL_BOUND[bf16], bf16)
            if not ok:
                raise AssertionError(f"forward hd sweep hd={hd}: err {err} > {bnd} or share "
                                     f"{share}")
            worst, worst_share = max(worst, err / bnd), max(worst_share, share)
        lse_err = (lse - ref_lse).abs().max().item() / ref_lse.abs().max().item()
        if lse_err > LSE_REL_BOUND or launches != (1, 1):
            raise AssertionError(f"forward hd sweep hd={hd}: lse rel err {lse_err}, launches "
                                 f"{launches}")
        worst_lse = max(worst_lse, lse_err)
    log(f"[kernel-flash] head dims: both bf16 forwards (#3, #5) at (N, L, H) = {SWEEP_SHAPE}, "
        f"hd {SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step {SWEEP_HEAD_DIMS.step}: "
        f"{2 * len(SWEEP_HEAD_DIMS)} rows within their bounds; the worst error {worst:.3f} of "
        f"its bound, the largest share of differing elements {worst_share:.5f}, the largest lse "
        f"error {worst_lse:.3e} of max|lse| (bound {LSE_REL_BOUND:.0e})")


def check_bwd_head_dims() -> None:
    """Both bf16 backwards on the tensor cores (#2 whole-row, #4 blocked:
    one pair of kernels, csrc/attention_bwd_mma.cuh) launch once per call and
    agree with their plain versions at every head dim of SWEEP_HEAD_DIMS, at
    SWEEP_SHAPE: BWD_REL_BOUND and BF16_MISMATCH_BOUND."""
    from maskdit_tpu_torch.ops import flash_batched, flash_big

    g = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16
    n, l, h = SWEEP_SHAPE
    pairs = ((flash_batched.packed_attention_bwd, flash_batched.packed_attention_bwd_reference),
             (flash_big.packed_attention_big_bwd, flash_big.packed_attention_big_bwd_reference))
    worst, worst_share = 0.0, 0.0
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(bf16)
        dout = torch.randn(n, l, h * hd, generator=g, device="cuda").to(bf16)
        for kernel, plain in pairs:
            before = kernel.launches
            got = kernel(qkv, dout, h, scale)
            torch.cuda.synchronize()
            launches = kernel.launches - before
            err, bnd, share, ok = compare(got, plain(qkv, dout, h, scale), BWD_REL_BOUND[bf16],
                                          bf16)
            if not (ok and launches == 1):
                raise AssertionError(f"backward hd sweep hd={hd} {kernel.__name__}: err {err} > "
                                     f"{bnd}, share {share} or {launches} launches")
            worst, worst_share = max(worst, err / bnd), max(worst_share, share)
    log(f"[kernel-big] head dims: both bf16 backwards (#2, #4) at (N, L, H) = {SWEEP_SHAPE}, "
        f"hd {SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step {SWEEP_HEAD_DIMS.step}: "
        f"{2 * len(SWEEP_HEAD_DIMS)} rows within their bounds; the worst error {worst:.3f} of "
        f"its bound, the largest share of differing elements {worst_share:.5f}")


def check_flash_bwd_head_dims() -> None:
    """The bf16 flash backward (#6) on the tensor cores launches once per
    call and agrees with its plain version (dq, dk, dv) at every head dim of
    SWEEP_HEAD_DIMS, at SWEEP_SHAPE, on the forward kernel's residuals:
    BWD_REL_BOUND and BF16_MISMATCH_BOUND."""
    from maskdit_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    n, l, h = SWEEP_SHAPE
    check_variant("flash bwd hd sweep", bf16, 8, flash.bwd_kernel(bf16))
    worst, worst_share = 0.0, 0.0
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        q, k, v, do = (torch.randn(n * h, l, hd, generator=g, device="cuda").to(bf16)
                       for _ in range(4))
        o, lse = flash.flash_fwd(q, k, v, scale)
        before = flash.flash_bwd.launches
        got = flash.flash_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        launches = flash.flash_bwd.launches - before
        ref = flash.flash_bwd_reference(q, k, v, o, lse, do, scale)
        for a, b in zip(got, ref):
            err, bnd, share, ok = compare(a, b, BWD_REL_BOUND[bf16], bf16)
            if not (ok and launches == 1):
                raise AssertionError(f"flash backward hd sweep hd={hd}: err {err} > {bnd}, share "
                                     f"{share} or {launches} launches")
            worst, worst_share = max(worst, err / bnd), max(worst_share, share)
    log(f"[kernel-flash] head dims: the bf16 flash backward (#6, mma) at (N, L, H) = "
        f"{SWEEP_SHAPE}, hd {SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step "
        f"{SWEEP_HEAD_DIMS.step}: {len(SWEEP_HEAD_DIMS)} rows (dq, dk, dv) within their bounds; "
        f"the worst error {worst:.3f} of its bound, the largest share of differing elements "
        f"{worst_share:.5f}")


def phase_flash_kernels() -> dict:
    """ops/flash.py's kernels (#5 and #6) over their window, both bf16
    forwards and the bf16 flash backward over the head dims, then #5 and #6
    at FLASH_SHAPES and FLASH_BWD_SHAPES, bf16 and fp32."""
    check_flash_window()
    check_fwd_head_dims()
    check_flash_bwd_head_dims()
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {"fwd": {}, "bwd": {}}
    for key, shapes, row, iters in (("fwd", FLASH_SHAPES, flash_fwd_row, 10),
                                    ("bwd", FLASH_BWD_SHAPES, flash_bwd_row, 5)):
        for name, n, l, h, hd in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                out[key][(name, dtype_name(dtype))] = row(name, n, l, h, hd, dtype, g, iters)
                free_device_memory()
    return out


def xl2_numel() -> int:
    """Parameters of DiT-XL/2 @256 with the decoder and MAE token, counted
    on the meta device (nothing is allocated)."""
    with torch.device("meta"):
        model = build_model(torch.bfloat16)
    return sum(p.numel() for p in model.parameters())


def library_adam_ms(grads, p, e, scalars, iters: int, with_ema: bool = True) -> float:
    """One PyTorch call of the same update: torch.optim.Adam(fused=True)
    .step() (the same math in fp32) and, with the EMA, torch._foreach_lerp_
    of the EMA towards the new params."""
    param = torch.nn.Parameter(p.clone())
    param.grad = grads
    ema = e.clone()
    opt = torch.optim.Adam([param], lr=scalars["lr"], betas=(scalars["b1"], scalars["b2"]),
                           eps=scalars["eps"], fused=True)

    def update():
        opt.step()
        if with_ema:
            torch._foreach_lerp_([ema], [param.detach()], scalars["one_minus_decay"])

    ms = cuda_ms(update, iters)
    del param, ema, opt
    return ms


def adam_variant_name(variant) -> str:
    g, m, v, ema = variant
    return (f"g {dtype_name(g)}, mu {dtype_name(m)}, nu {dtype_name(v)}, "
            f"EMA {'on' if ema else 'off'}")


def check_stochastic_rounding() -> dict:
    """The kernel's bf16 nu on the card: with b2 = 0 and (1 - b2) = x, g = 1,
    it stores SR(x) for SR_VALUES elements; for x a fraction f of a gap
    above 1.0 the mean lands within 2% of the gap of x and every value is
    1.0 or 1.0 + gap; a bf16 value (f = 0) stays exact."""
    from maskdit_tpu_torch.ops import fused_adam

    lo, gap = 1.0, 2.0 ** -7
    out = {}
    for count, f in enumerate((0.0, 0.25, 0.5, 0.75)):
        x = lo + f * gap
        scalars = fused_adam.adam_scalars(1e-4, 7, 0.9, 0.999, 1e-8, 0.9999)
        scalars.update(b2=0.0, one_minus_b2=x)
        ones, zeros = torch.ones(SR_VALUES, device="cuda"), torch.zeros(SR_VALUES, device="cuda")
        nu = torch.zeros(SR_VALUES, device="cuda", dtype=torch.bfloat16)
        fused_adam.launch(ones, zeros.clone(), zeros.clone(), nu, zeros.clone(), scalars,
                          sr_count=count)
        values = nu.float()
        off = abs(float(values.double().mean()) - x) / gap
        seen = sorted(values.unique().tolist())
        ok = off < 0.02 and set(seen) <= ({lo} if f == 0 else {lo, lo + gap})
        out[f] = off
        if not ok:
            raise AssertionError(f"stochastic rounding of {x}: mean off by {off} gaps, "
                                 f"values {seen}")
    log(f"[kernel] fused adam, stochastic rounding of nu over {SR_VALUES} values: |mean - x| "
        f"in bf16 gaps at f = 0, 0.25, 0.5, 0.75 of a gap above 1.0: "
        f"{[f'{v:.2e}' for v in out.values()]} (bound 0.02); bf16 values exact, the rest one "
        f"of their two neighbours")
    return out


def phase_adam_kernel() -> dict:
    """Kernel #7 over all of DiT-XL/2's parameters in each of ADAM_VARIANTS,
    against its plain version, with the kernel's, the plain version's and
    (where one PyTorch call computes the same function) the library's time
    and the bytes bound; then its stochastic rounding."""
    from maskdit_tpu_torch.ops import fused_adam

    n = xl2_numel()
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda: torch.randn(n, generator=g, device="cuda")
    grads, p, e, v, m = rnd(), rnd(), rnd(), rnd().abs_().mul_(1e-2), rnd().mul_(0.1)
    scalars = fused_adam.adam_scalars(1e-4, 7, 0.9, 0.999, 1e-8, 0.9999)
    out = {}
    for variant in ADAM_VARIANTS:
        g_dt, m_dt, v_dt, with_ema = variant
        args = (grads.to(g_dt), p, m.to(m_dt), v.to(v_dt), e)
        want = fused_adam.fused_adam_ema_reference(*args, **scalars, sr_count=6,
                                                   with_ema=with_ema)
        got = [t.clone() for t in args[1:]]
        before = fused_adam.fused_adam_ema.launches
        fused_adam.launch(args[0], *got, scalars, sr_count=6, with_ema=with_ema)
        torch.cuda.synchronize()
        launches = fused_adam.fused_adam_ema.launches - before
        exact = variant not in ADAM_VARIANTS[:2]
        err, ok = 0.0, launches == 1
        for name, a, b in zip(("p", "m", "v", "ema"), got, want):
            diff = (a.float() - b.float()).abs()
            err = max(err, diff.max().item())
            if exact:
                ok = ok and torch.equal(a, b)
            elif name == "m" and m_dt == torch.bfloat16:
                ok = ok and bool((diff <= b.float().abs() * 2.0 ** -7 + ADAM_ATOL).all())
            else:
                ok = ok and bool((diff <= b.float().abs() * ADAM_RTOL + ADAM_ATOL).all())
            del diff
        ms = cuda_ms(lambda: fused_adam.launch(args[0], *got, scalars, sr_count=6,
                                               with_ema=with_ema), 10)
        plain_ms = cuda_ms(lambda: fused_adam.fused_adam_ema_reference(
            *args, **scalars, sr_count=6, with_ema=with_ema), 3)
        # reads g, p, m, v (and e); writes p, m, v (and e)
        moved = n * (args[0].element_size() + 8 + 2 * args[2].element_size()
                     + 2 * args[3].element_size() + (8 if with_ema else 0))
        ops = ADAM_OPS - (0 if with_ema else 3)
        bound_ms, bound_by = bound(ops * n, moved, torch.float32)
        library_ms = None
        if g_dt == m_dt == v_dt == torch.float32:  # Adam(fused) keeps all in fp32
            library_ms = library_adam_ms(args[0], p, e, scalars, 10, with_ema)
        name = adam_variant_name(variant)
        log(f"[kernel] fused adam over {n} params (DiT-XL/2), {name}: max_abs_err {err:.3e} "
            + ("(bit for bit)" if exact else f"(bound per element {ADAM_RTOL:.0e}|ref| + "
               f"{ADAM_ATOL:.0e})")
            + f"; kernel {ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s, {moved / n:.0f} B/param), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{bound_ms / ms:.3f} of it; library "
            + ("none (no PyTorch call keeps these dtypes)" if library_ms is None else
               f"{library_ms:.4f} ms ({ms / library_ms:.2f}x)")
            + f"; launches per update {launches}")
        if not ok:
            raise AssertionError(f"fused_adam_ema {name}: err {err}, launches {launches}")
        out[variant] = dict(err=err, ms=ms, plain_ms=plain_ms, gbps=moved / ms / 1e6,
                            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del args, want, got
    del grads, p, e, v, m
    free_device_memory()
    out["sr"] = check_stochastic_rounding()
    free_device_memory()
    return out


def build_model(dtype: torch.dtype, res: int = 32, use_flash=None):
    from maskdit_tpu_torch.models import create_model

    return create_model(
        "edm", img_resolution=res, img_channels=4, num_classes=1000,
        model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1, dtype=dtype,
        use_flash=use_flash,
    )


def random_weights_(model) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)


def phase_weights() -> str:
    model = build_model(torch.bfloat16).cuda()
    random_weights_(model)
    n_params = sum(p.numel() for p in model.parameters())
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "random-xl2.pt")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    torch.save({"ema": state}, path)
    log(f"[weights] DiT-XL/2, {n_params} params ~ N(0, 0.02^2), seed 0; "
        f"saved in {time.perf_counter() - t0:.1f} s")
    return path


def run_generate(tag: str, argv: list, seeds: int, res: int) -> tuple[dict, dict]:
    """The generate CLI with the launch counts set to 0 before it; checks
    the latents; returns the CLI's result and the launch counts."""
    from maskdit_tpu_torch import generate

    outdir = argv[argv.index("--outdir") + 1]
    shutil.rmtree(outdir, ignore_errors=True)
    reset_launches()
    result = generate.main(argv)
    launches = read_launches()
    z = np.load(os.path.join(outdir, "latents_000000.npy"))
    log(f"[{tag}] latents {z.shape} {z.dtype}, finite {bool(np.isfinite(z).all())}, "
        f"std {float(z.std()):.4f}")
    ips = result["images"] / result["seconds"]
    log(f"[{tag}] {result['images']} images, {STEPS} steps, CFG {CFG}, bf16: "
        f"{result['seconds']:.3f} s, {ips:.3f} images/s (first batch, no warm-up)")
    if z.shape != (seeds, 4, res, res) or not np.isfinite(z).all():
        raise AssertionError(f"{tag}: bad latents: shape {z.shape}")
    return dict(images_per_s=ips, seconds=result["seconds"]), launches


def phase_main(ckpt: str) -> dict:
    argv = [
        "--ckpt_path", ckpt, "--outdir", os.path.join(SCRATCH, "samples"), "--no_decode",
        "--seeds", f"0-{SEEDS - 1}", "--max_batch_size", str(SEEDS),
        "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
        "--model_type", "DiT-XL/2", "--image_size", "32", "--image_channels", "4",
        "--num_classes", "1000", "--use_decoder", "True", "--mae_loss_coef", "0.1",
    ]
    out, launches = run_generate("main", argv, SEEDS, 32)
    expect_launches("main", launches, packed_fwd=(2 * STEPS - 1) * (DEPTH + DECODER_DEPTH))
    return dict(out, launches=launches)


def phase_main_512(ckpt: str) -> dict:
    """The generate CLI on configs/test/maskdit-512.yaml (as JSON), with the
    256-px checkpoint: it loads strictly, so one parameter set serves both."""
    os.makedirs(SCRATCH, exist_ok=True)
    config = os.path.join(SCRATCH, "maskdit-512.json")
    with open(config, "w") as f:
        json.dump(SAMPLE_CONFIG_512, f)
    argv = [
        "--ckpt_path", ckpt, "--outdir", os.path.join(SCRATCH, "samples-512"), "--no_decode",
        "--config", config, "--seeds", f"0-{SEEDS_512 - 1}", "--max_batch_size",
        str(SEEDS_512), "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
    ]
    out, launches = run_generate("main-512", argv, SEEDS_512, 64)
    expect_launches("main-512", launches, big_fwd=(2 * STEPS - 1) * (DEPTH + DECODER_DEPTH))
    return dict(out, launches=launches)


@contextlib.contextmanager
def plain_attention():
    """Swap the plain attention (forward and backward) into the model's
    layers, for comparison."""
    from maskdit_tpu_torch.models import layers
    from maskdit_tpu_torch.ops import flash
    from maskdit_tpu_torch.ops.flash_batched import packed_attention_plain
    from maskdit_tpu_torch.ops.flash_big import packed_attention_big_plain

    kernels = layers.packed_attention, layers.packed_attention_big, flash.flash_mha
    layers.packed_attention = packed_attention_plain
    layers.packed_attention_big = packed_attention_big_plain
    flash.flash_mha = flash.flash_mha_plain  # what ops/attention.mha calls
    try:
        yield
    finally:
        layers.packed_attention, layers.packed_attention_big, flash.flash_mha = kernels


@contextlib.contextmanager
def plain_update():
    """Swap the plain Adam + EMA update (in place, same scalars) into the
    optimizer, for comparison."""
    from maskdit_tpu_torch.ops import fused_adam

    kernel = fused_adam.fused_adam_ema
    fused_adam.fused_adam_ema = fused_adam.fused_adam_ema_plain
    try:
        yield
    finally:
        fused_adam.fused_adam_ema = kernel


def phase_model_parity(ckpt: str, tag: str = "parity", res: int = 32, seeds: int = SEEDS,
                       sampling_turns=("plain", "kernel", "kernel", "plain")) -> dict:
    """The CFG denoiser, kernels vs plain attention, in bf16 and fp32; then
    warm images/s of the whole sampler (kernel and plain in the turns
    given) and a profile of one evaluation, in bf16."""
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    state = load_reference_checkpoint(ckpt)
    x, sigma, y = denoiser_inputs(seeds, res)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = parity_model(state, dtype, res)
        out[dtype_name(dtype)] = check_denoiser(tag, model, x, sigma, y)
        if dtype == torch.bfloat16:
            out["sampling"] = time_sampling(model, seeds, res, sampling_turns)
            profile_forward(model, x, sigma, y, "profile" if res == 32 else "profile-512")
        del model
    free_device_memory()
    return out


def denoiser_inputs(seeds: int, res: int):
    """Latents, noise levels and one-hot labels of a CFG evaluation, from a
    seed."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(seeds, 4, res, res)).astype(np.float32)).cuda()
    sigma = torch.from_numpy(rng.uniform(0.5, 5.0, size=seeds).astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 1000, size=seeds)), 1000
    ).float().cuda()
    return x, sigma, y


def parity_model(state: dict, dtype: torch.dtype, res: int, use_flash=None):
    from maskdit_tpu_torch.utils.ckpt import load_into

    model = build_model(dtype, res, use_flash)
    load_into(model, state)
    return model.cuda().eval()


def check_denoiser(tag: str, model, x, sigma, y, **launches) -> float:
    """The CFG denoiser, kernels vs plain attention: max|kernel - plain| /
    max|plain| within MODEL_REL_BOUND of the model's type; with
    ``launches``, the kernels' run launched exactly those."""
    dtype = model.model.dtype
    with torch.no_grad():
        reset_launches()
        got = model(x, sigma, y, cfg_scale=CFG)["x"]
        torch.cuda.synchronize()
        if launches:
            expect_launches(tag, read_launches(), **launches)
        with plain_attention():
            ref = model(x, sigma, y, cfg_scale=CFG)["x"]
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    dt = dtype_name(dtype)
    bnd = MODEL_REL_BOUND[dtype]
    res = x.shape[-1]
    log(f"[{tag}] EDMPrecond CFG forward at {res * 8} px, batch {x.shape[0]}, {dt}: kernel vs "
        f"plain max rel err {rel:.3e} (bound {bnd:.0e}), finite "
        f"{bool(torch.isfinite(got).all())}")
    if not (torch.isfinite(got).all() and rel <= bnd):
        raise AssertionError(f"{tag} {dt}: {rel} > {bnd}")
    return rel


def phase_flash_parity(ckpt: str) -> dict:
    """One CFG denoiser evaluation at 512 px with ``use_flash=True``: the
    flash kernels (one forward launch per block, 28 + 8, and no other
    attention kernel) vs their plain versions, in bf16 and fp32."""
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    state = load_reference_checkpoint(ckpt)
    x, sigma, y = denoiser_inputs(SEEDS_512, 64)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = parity_model(state, dtype, 64, use_flash=True)
        out[dtype_name(dtype)] = check_denoiser("parity-flash", model, x, sigma, y,
                                                flash_fwd=DEPTH + DECODER_DEPTH)
        del model
    free_device_memory()
    return out


def time_sampling(model, seeds: int, res: int, turns) -> dict:
    """Warm images/s of the whole sampler at the batch of ``seeds``, with the
    kernels and with the plain attention, in the turns given."""
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params

    cfg = SamplerConfig(num_steps=STEPS, cfg_scale=CFG)
    times = {"plain": [], "kernel": []}
    for which in turns:
        ctx = plain_attention() if which == "plain" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_with_params(model, list(range(seeds)), None, cfg, max_batch_size=seeds)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
    ips = {k: [seeds / t for t in v] for k, v in times.items()}
    log(f"[sampling] warm at {res * 8} px, batch {seeds}, {STEPS} steps, CFG {CFG}, bf16: "
        f"images/s kernel {ips['kernel']}, plain {ips['plain']}")
    return ips


def profile_device(tag: str, fn, reps: int, what: str) -> None:
    """Wall time of ``fn`` unprofiled, then device time by kernel name
    from torch.profiler, per call, over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    launches = sum(e.count for e in events) // reps
    log(f"[{tag}] {what}: wall {wall_ms:.3f} ms (unprofiled), device busy {busy_ms:.3f} ms "
        f"in {launches} device ops (profiled), idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:12]:
        log(f"[{tag}]   {e.self_device_time_total / reps / 1e3:8.3f} ms  x{e.count // reps:4d}  "
            f"{e.key[:100]}")


def profile_forward(model, x, sigma, y, tag: str) -> None:
    """Device time by kernel over 3 CFG forwards (one denoiser evaluation
    each), from torch.profiler."""
    def evaluate():
        with torch.no_grad():
            model(x, sigma, y, cfg_scale=CFG)

    profile_device(tag, evaluate, 3,
                   f"one CFG denoiser evaluation (batch {x.shape[0]} x 2, {x.shape[-1] * 8} px)")


@contextlib.contextmanager
def no_checkpoint_writes():
    """The trainer's checkpoints are recorded, not written: a call on the
    card's machine may write 45 GiB, and [train], [train-512] and
    [train-flash] write three 10.9-GiB checkpoints of DiT-XL/2 already
    ([train] holds the writes and the resume)."""
    from maskdit_tpu_torch.utils.ckpt import CheckpointManager

    save = CheckpointManager.save
    CheckpointManager.save = lambda self, step, ckpt: self.path(step)
    try:
        yield
    finally:
        CheckpointManager.save = save


def params_digest(params: torch.Tensor) -> str:
    """sha256 of a flat parameter buffer's bytes (bit-for-bit comparisons
    across processes)."""
    import hashlib

    return hashlib.sha256(params.detach().cpu().numpy().tobytes()).hexdigest()


def run_train(tag: str, config: dict, res: int, per_step: dict, overrides=(), options=(),
              extra=None, write_checkpoints: bool = True, digest: bool = False) -> dict:
    """The train main path through the CLI on ``config`` with the CLI
    ``options`` and config ``overrides``, with the launch counts set to 0
    before it; checks the losses and that each step launched the kernels
    ``per_step`` names that many times, the run ``extra`` more, and no other.
    Without ``write_checkpoints`` the run's checkpoints are not written;
    with ``digest`` the result holds the final parameters' sha256."""
    from maskdit_tpu_torch.train import main as train_main
    from maskdit_tpu_torch.train.cli import apply_overrides
    from maskdit_tpu_torch.utils.profiling import (
        maskdit_train_flops_per_image,
        mfu,
        peak_bf16_tflops,
    )

    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    results = os.path.join(SCRATCH, tag)
    shutil.rmtree(results, ignore_errors=True)
    free_device_memory()
    ctx = contextlib.nullcontext() if write_checkpoints else no_checkpoint_writes()
    reset_launches()
    with ctx:
        out = train_main(["--config", path, "--results_dir", results, "--device", "cuda",
                          "--num_workers", "4", *options, *overrides])
    launches = read_launches()
    steps, history = out["step"], out["history"]
    state = out.pop("state")
    digest = params_digest(state.params) if digest else None
    del state
    config = apply_overrides(json.loads(json.dumps(config)), overrides)
    t = config["train"]
    batch, max_steps = t["batchsize"] * t.get("grad_accum", 1), t["max_num_steps"]
    losses = [x for r in history for x in r["losses"]]
    log(f"[{tag}] {steps} steps of DiT-XL/2 @{res * 8}, batch {batch}, mask 0.5, bf16: "
        f"losses {[round(x, 4) for x in losses]}")
    if steps != max_steps or len(losses) != max_steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {steps} steps, losses {losses}")
    extra = extra or {}
    expect_launches(tag, launches, **{name: per_step.get(name, 0) * steps + extra.get(name, 0)
                                      for name in {*per_step, *extra}})
    warm = history[1:]  # the first window holds steps 1-2 (warm-up)
    seconds = sum(LOG_EVERY / r["steps_per_sec"] for r in warm)
    warm_steps = LOG_EVERY * len(warm)
    ips = warm_steps * batch / seconds
    name = torch.cuda.get_device_name(0)
    flops = maskdit_train_flops_per_image("DiT-XL/2", res, 0.5, True)
    util = mfu(ips, flops, peak_bf16_tflops(name))
    peak = max(r["mem_peak_gib"] for r in history)
    log(f"[{tag}] warm steps {LOG_EVERY + 1}-{steps}: {ips:.2f} images/s, "
        f"{seconds / warm_steps * 1e3:.1f} ms/step, MFU {util:.4f} of "
        f"{peak_bf16_tflops(name):.0f} TFLOP/s bf16 ({flops / 1e9:.1f} GFLOP/image), peak memory "
        f"{peak:.2f} GiB; per window images/s {[round(r['images_per_sec'], 2) for r in history]}")
    return dict(launches=launches, images_per_s=ips, ms_per_step=seconds / warm_steps * 1e3,
                mfu=util, peak_gib=peak, results=results, exp_dir=out["exp_dir"],
                losses=losses, digest=digest)


def phase_train(vae_path: str, stats: str) -> dict:
    """The 256-px train main path with ``--enable_eval`` ([train-eval]: the
    checkpoint after the last step, ``log.ckpt_every`` 12, runs the eval hook
    on seeds 0-7, CFG 1.5, 40 steps, [vae]'s file and the random detector
    against [eval]'s statistics; metrics.jsonl must hold a finite eval/fid at
    step 12), then resume from that checkpoint. The hook rides on the
    checkpoint the run writes anyway: a run of its own would write another
    10.9 GiB, past what the card's machine lets one call write to its disk."""
    options = ("--enable_eval", "--eval_seeds", f"0-{SEEDS - 1}", "--cfg_scale", str(CFG),
               "--num_steps", str(STEPS), "--max_batch_size", str(SEEDS),
               "--num_expected", str(SEEDS), "--pretrained_path", vae_path, "--random_detector")
    out = run_train("train", TRAIN_CONFIG, 32, dict(packed_fwd=ATTN_PER_STEP,
                                                   packed_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP),
                    (f"log.ckpt_every={TRAIN_STEPS}", f"eval.ref_path={stats}"), options,
                    extra=dict(packed_fwd=(2 * STEPS - 1) * (DEPTH + DECODER_DEPTH)))
    with open(os.path.join(out["exp_dir"], "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "eval/fid" in r]
    log(f"[train-eval] the eval hook after the step-{TRAIN_STEPS} checkpoint: {evals}")
    if len(evals) != 1 or evals[0]["step"] != TRAIN_STEPS or not np.isfinite(evals[0]["eval/fid"]):
        raise AssertionError(f"train-eval: eval records {evals}")
    out["eval_fid"] = evals[0]["eval/fid"]
    out["resume"] = check_resume(out["results"])
    return out


def check_resume(results: str) -> bool:
    """A trainer built on the results directory resumes from the newest
    checkpoint: step, params, EMA, mu and nu equal the file exactly."""
    from maskdit_tpu_torch.train.trainer import Trainer

    free_device_memory()
    t0 = time.perf_counter()
    trainer = Trainer(json.loads(json.dumps(TRAIN_CONFIG)), results_dir=results, device="cuda")
    ckpt = trainer.ckpt_mgr.restore()
    state = trainer.state
    same = state.step == ckpt["step"] == TRAIN_STEPS and state.opt_state.count == ckpt["opt"]["count"]
    for flat, saved in ((state.params, ckpt["model"]), (state.ema, ckpt["ema"]),
                        (state.opt_state.mu, ckpt["opt"]["mu"]), (state.opt_state.nu, ckpt["opt"]["nu"])):
        named = state.named(flat)
        same = same and sorted(named) == sorted(saved) and all(
            torch.equal(named[k], saved[k].to(named[k].device)) for k in saved
        )
    size = os.path.getsize(trainer.ckpt_mgr.path(TRAIN_STEPS)) / 1024 ** 3
    log(f"[train] resume from step {state.step}: params, EMA, mu, nu equal to the checkpoint "
        f"{same} ({size:.2f} GiB file; built and restored in {time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("resume did not restore the checkpoint exactly")
    del trainer, state, ckpt
    free_device_memory()
    return same


def train_parity_state(dtype: torch.dtype, seed: int, res: int, batch: int, use_flash=None,
                       **opt_kw):
    """A DiT-XL/2 train state with random weights and a non-trivial Adam
    state (count 10, mu ~ N(0, 1e-4^2), nu ~ |N(0, 1e-7^2)|), the same for
    the same seed; ``opt_kw`` go to make_optimizer (the moments' dtypes)."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer

    torch.manual_seed(seed)
    model = build_model(dtype, res, use_flash).cuda()
    random_weights_(model)
    opt = make_optimizer(1e-4, batch, **opt_kw)
    state = create_train_state(model, opt)
    g = torch.Generator(device="cuda").manual_seed(seed)
    state.opt_state.count = 10
    state.opt_state.mu.normal_(0.0, 1e-4, generator=g)
    state.opt_state.nu.normal_(0.0, 1e-7, generator=g).abs_()
    return state, opt


def parity_batch(res: int, n: int):
    """A batch of moments and labels and the step's draws, from a seed."""
    from maskdit_tpu_torch.models.masking import random_mask
    from maskdit_tpu_torch.train.state import StepDraws

    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"x": torch.randn(n, 8, res, res, device="cuda", generator=g),
             "y": torch.nn.functional.one_hot(
                 torch.randint(0, 1000, (n,), device="cuda", generator=g), 1000).float()}
    draws = StepDraws(
        z_noise=torch.randn(n, 4, res, res, device="cuda", generator=g),
        drop_u=torch.rand(n, 1, device="cuda", generator=g),
        sigma=torch.exp(torch.randn(n, device="cuda", generator=g) * 1.2 - 1.2),
        noise=torch.randn(n, 4, res, res, device="cuda", generator=g),
        mask_info=random_mask(n, (res // 2) ** 2, 0.5, g, device="cuda"),
    )
    return batch, draws


def train_step_result(dtype: torch.dtype, res: int, batch: dict, draws, use_flash=None,
                      plain: bool = False) -> dict:
    """One train step from train_parity_state's state: the loss, the
    gradients and the updated p/ema/mu/nu, through the kernels or (``plain``)
    the plain attention and update."""
    from maskdit_tpu_torch.train.state import make_train_step

    free_device_memory()
    state, opt = train_parity_state(dtype, 4, res, batch["x"].shape[0], use_flash)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999)
    ctx = contextlib.ExitStack()
    if plain:
        ctx.enter_context(plain_attention())
        ctx.enter_context(plain_update())
    with ctx:
        metrics = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    result = dict(
        loss=float(metrics["loss"]),
        grads={k: v.clone() for k, v in state.named(state.grads).items()},
        state={f"{name}.{k}": v.clone() for name, flat in (
            ("p", state.params), ("ema", state.ema), ("mu", state.opt_state.mu),
            ("nu", state.opt_state.nu)) for k, v in state.named(flat).items()},
    )
    del state, opt, step, metrics
    return result


def compare_steps(tag: str, what: str, dtype: torch.dtype, res: int, n: int, got: dict,
                  ref: dict) -> dict:
    """Two train steps' loss, gradients and state within TRAIN_PARITY_BOUND."""
    rel_norm = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
    loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err = max(rel_norm(got["grads"][k], v) for k, v in ref["grads"].items())
    worst = max(ref["grads"], key=lambda k: rel_norm(got["grads"][k], ref["grads"][k]))
    state_err = max(rel_norm(got["state"][k], v) for k, v in ref["state"].items())
    # a gradient that reaches the encoder's first qkv passed through
    # every attention backward above it
    qkv_norm = got["grads"]["model.blocks.0.attn.qkv.weight"].norm().item()
    bnd = TRAIN_PARITY_BOUND[dtype]
    dt = dtype_name(dtype)
    log(f"[{tag}] one step, DiT-XL/2 @{res * 8}, batch {n}, {dt}, {what}: loss "
        f"{got['loss']:.6f} vs {ref['loss']:.6f}, rel err {loss_err:.3e} (bound "
        f"{bnd['loss']:.0e}); max per-tensor gradient rel-norm err {grad_err:.3e} (bound "
        f"{bnd['grad']:.0e}, worst {worst}); max per-tensor p/ema/mu/nu rel-norm err "
        f"{state_err:.3e} (bound {bnd['state']:.0e}); |grad| of blocks.0.attn.qkv "
        f"{qkv_norm:.3e}")
    if not (loss_err <= bnd["loss"] and grad_err <= bnd["grad"]
            and state_err <= bnd["state"] and qkv_norm > 0):
        raise AssertionError(f"{tag} {dt} {what}: loss {loss_err}, grad {grad_err}, "
                             f"state {state_err}")
    return dict(loss=loss_err, grad=grad_err, state=state_err)


def phase_parity_train(tag: str = "parity-train", res: int = 32, n: int = PARITY_BATCH,
                       use_flash=None) -> dict:
    """One train step from one state with the same injected draws, through
    the kernels and through the plain attention and update; with
    ``use_flash``, also (fp32) the flash step against the default one on
    the blocked kernels: the flag changes the algorithm, not the model."""
    batch, draws = parity_batch(res, n)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = train_step_result(dtype, res, batch, draws, use_flash)
        if use_flash and dtype == torch.float32:
            ref = train_step_result(dtype, res, batch, draws)
            out["flash_vs_blocked"] = compare_steps(tag, "use_flash vs the blocked kernels",
                                                    dtype, res, n, got, ref)
            del ref
        ref = train_step_result(dtype, res, batch, draws, use_flash, plain=True)
        out[dtype_name(dtype)] = compare_steps(tag, "kernels vs plain", dtype, res, n, got, ref)
        del got, ref
    free_device_memory()
    return out


def state_tensors(state) -> dict:
    """A train state's gradient and p / ema / mu / nu, per parameter (views)."""
    out = {f"grad.{k}": v for k, v in state.named(state.grads).items()}
    for name, flat in (("p", state.params), ("ema", state.ema), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        out.update({f"{name}.{k}": v for k, v in state.named(flat).items()})
    return out


def phase_parity_train_options(res: int = 32, n: int = PARITY_BATCH) -> dict:
    """One bf16 train step with every option of [train-options] (amp_grads,
    a bf16 accumulator over 2 micro-batches, bf16 mu and nu, ema_every 2 on
    an EMA step: decay^2) from one state with the same injected draws,
    through the kernels and through the plain attention and update, held
    to [parity-train]'s bf16 bounds; and kernel #7 bit for bit: the plain
    update of the kernel step's own gradient from the state before it gives
    the kernel's p, mu, nu and EMA."""
    from maskdit_tpu_torch.ops import fused_adam
    from maskdit_tpu_torch.train.state import make_train_step

    batch, draws = parity_batch(res, n)
    kw = dict(grad_accum=2, amp_grads=True, accum_dtype="bfloat16", ema_every=2)
    results = []
    for plain in (False, True):
        free_device_memory()
        state, opt = train_parity_state(torch.bfloat16, 4, res, n, moment_dtype="bfloat16",
                                        nu_dtype="bfloat16")
        state.step = 1  # (1 + 1) % 2 == 0: the EMA moves, with decay^2
        before = [t.clone() for t in (state.params, state.opt_state.mu, state.opt_state.nu,
                                      state.ema)]
        count = state.opt_state.count
        step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999, **kw)
        ctx = contextlib.ExitStack()
        if plain:
            ctx.enter_context(plain_attention())
            ctx.enter_context(plain_update())
        reset_launches()
        with ctx:
            metrics = step(state, batch, draws=draws)
        torch.cuda.synchronize()
        launches = read_launches()
        if not plain:
            expect_launches("parity-train-options", launches, packed_fwd=2 * ATTN_PER_STEP,
                            packed_bwd=2 * ATTN_PER_STEP, adam=ADAM_PER_STEP)
            if state.grads.dtype != torch.bfloat16 or state.opt_state.nu.dtype != torch.bfloat16:
                raise AssertionError("parity-train-options: the options did not take")
            fused_adam.fused_adam_ema_plain(
                state.grads, *before, lr=opt.lr_at(count), count_inc=count + 1,
                ema_decay=0.9999 ** 2)
            same = [torch.equal(a, b) for a, b in zip(
                before, (state.params, state.opt_state.mu, state.opt_state.nu, state.ema))]
            log(f"[parity-train-options] kernel #7 (g, mu, nu bf16, EMA on) vs its plain "
                f"version on the step's own gradient: p, mu, nu, EMA equal bit for bit {same}")
            if not all(same):
                raise AssertionError(f"parity-train-options: kernel #7 vs plain {same}")
        del before
        results.append(dict(loss=float(metrics["loss"]), grads={
            k: v.clone() for k, v in state.named(state.grads).items()}, state={
            k: v.clone() for k, v in state_tensors(state).items() if not k.startswith("grad.")}))
        del state, opt, step, metrics
    out = compare_steps("parity-train-options", "amp_grads, bf16 accumulator x2, bf16 mu and "
                        "nu, ema_every 2: kernels vs plain", torch.bfloat16, res, n, *results)
    del results
    free_device_memory()
    return out


def phase_train_options(train: dict) -> dict:
    """The train CLI on TRAIN_CONFIG with TRAIN_OPTIONS: finite losses, 36 +
    36 attention launches per micro-batch and one update per step; its
    ms/step, images/s and peak memory beside [train]'s."""
    out = run_train("train-options", TRAIN_CONFIG, 32, dict(
        packed_fwd=TRAIN_OPTIONS_ACCUM * ATTN_PER_STEP,
        packed_bwd=TRAIN_OPTIONS_ACCUM * ATTN_PER_STEP, adam=ADAM_PER_STEP),
        TRAIN_OPTIONS, write_checkpoints=False)
    log(f"[train-options] global batch {TRAIN_OPTIONS_MICRO * TRAIN_OPTIONS_ACCUM} "
        f"({TRAIN_OPTIONS_ACCUM} x {TRAIN_OPTIONS_MICRO}): {out['ms_per_step']:.1f} ms/step, "
        f"{out['images_per_s']:.2f} images/s, peak {out['peak_gib']:.2f} GiB; [train] "
        f"(batch {TRAIN_BATCH}, no options): {train['ms_per_step']:.1f} ms/step, "
        f"{train['images_per_s']:.2f} images/s, peak {train['peak_gib']:.2f} GiB")
    return out


def launch_workers(tag: str, nproc: int, *args: str) -> dict:
    """Run this script's worker ``tag`` in ``nproc`` processes under
    torch.distributed.run (a rendezvous on localhost); its output is logged;
    returns the JSON rank 0 writes."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    result = os.path.join(SCRATCH, f"{tag}.json")
    os.makedirs(SCRATCH, exist_ok=True)
    if os.path.exists(result):
        os.remove(result)
    free_device_memory()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
         "--master_addr", "127.0.0.1", "--master_port", str(port), os.path.abspath(__file__),
         "--worker", tag, result, *args],
        capture_output=True, text=True, timeout=WORKER_TIMEOUT, cwd=ROOT,
    )
    for line in proc.stdout.splitlines():
        log(f"[{tag}:out] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: the workers failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(result) as f:
        out = json.load(f)
    out["seconds"] = time.perf_counter() - t0
    log(f"[{tag}] {nproc} process(es) in {out['seconds']:.1f} s")
    return out


def phase_parity_ddp() -> dict:
    """Two ranks over gloo on the one card, one fp32 step (TF32 off) on an
    injected global batch of PARITY_DDP_BATCH: the replicas equal bit for
    bit; against one process's step on the whole batch within
    [parity-train]'s fp32 bounds."""
    out = launch_workers("parity-ddp", 2)
    log(f"[parity-ddp] replicas equal bit for bit {out['replicas_equal']}; launches per rank "
        f"{out['launches']}")
    if not out["replicas_equal"]:
        raise AssertionError("parity-ddp: the two ranks' parameters differ")
    bnd = TRAIN_PARITY_BOUND[torch.float32]
    if not (out["loss"] <= bnd["loss"] and out["grad"] <= bnd["grad"]
            and out["state"] <= bnd["state"]):
        raise AssertionError(f"parity-ddp: {out}")
    return out


def phase_train_ddp() -> dict:
    """The train CLI on TRAIN_CONFIG in two gloo ranks sharing the card
    (``--device cuda:0 --dist_backend gloo``), DDP_STEPS steps at a global
    batch of DDP_BATCH: finite losses, one log line per step (rank 0's),
    equal parameter digests on both ranks."""
    out = launch_workers("train-ddp", 2)
    lines = out["log_lines"]
    log(f"[train-ddp] losses {[round(x, 4) for x in out['losses']]}; log lines per logged "
        f"step (every {LOG_EVERY}), both ranks: {lines}; parameter digests {[d[:16] for d in out['digests']]}; launches (both "
        f"ranks) {out['launches']}; {out['ms_per_step']:.1f} ms/step")
    per_rank = dict(packed_fwd=ATTN_PER_STEP * DDP_STEPS, packed_bwd=ATTN_PER_STEP * DDP_STEPS,
                    adam=DDP_STEPS)
    expect_launches("train-ddp", out["launches"], **{k: 2 * v for k, v in per_rank.items()})
    if (len(set(out["digests"])) != 1 or lines != [1] * (DDP_STEPS // LOG_EVERY)
            or len(out["losses"]) != DDP_STEPS or not np.all(np.isfinite(out["losses"]))):
        raise AssertionError(f"train-ddp: {out}")
    return out


def phase_train_ddp_nccl() -> dict:
    """One rank over NCCL (its collectives over itself) against the same
    DDP_STEPS steps of the CLI without a process group, both drawing through
    ``draw_step``: the final parameters equal bit for bit."""
    out = launch_workers("train-ddp-nccl", 1)
    alone = run_train("train-ddp-alone", TRAIN_CONFIG, 32, dict(
        packed_fwd=ATTN_PER_STEP, packed_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP),
        (f"train.batchsize={DDP_BATCH}", *DDP_OVERRIDES), write_checkpoints=False, digest=True)
    expect_launches("train-ddp-nccl", out["launches"], packed_fwd=ATTN_PER_STEP * DDP_STEPS,
                    packed_bwd=ATTN_PER_STEP * DDP_STEPS, adam=DDP_STEPS)
    same = out["digests"] == [alone["digest"]] and out["losses"] == alone["losses"]
    log(f"[train-ddp-nccl] backend {out['backend']}: parameters {out['digests'][0][:16]} vs "
        f"without a group {alone['digest'][:16]}, losses equal "
        f"{out['losses'] == alone['losses']}: bit for bit {same}; "
        f"{out['ms_per_step']:.1f} vs {alone['ms_per_step']:.1f} ms/step")
    if not same:
        raise AssertionError(f"train-ddp-nccl: {out} vs {alone}")
    out["alone"] = alone
    return out


def worker(tag: str, result: str, *args: str) -> None:
    """One process of a data-parallel phase, under torch.distributed.run."""
    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.parallel.data_parallel import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if tag == "parity-ddp":
        dist.init_distributed(backend="gloo", device="cuda:0")
        out = worker_parity_ddp(DataParallel())
    elif tag in ("train-ddp", "train-ddp-nccl"):
        gloo = tag == "train-ddp"
        device = "cuda:0" if gloo else "cuda"
        dist.init_distributed(backend="gloo" if gloo else "nccl", device=device)
        out = worker_train(device, gloo)
    else:
        raise SystemExit(f"unknown worker {tag}")
    if dist.is_main_process():
        with open(result, "w") as f:
            json.dump(out, f)
    dist.shutdown()


def worker_parity_ddp(sync) -> dict:
    """[parity-ddp] in one rank: the data-parallel step on this rank's rows,
    the replicas compared, then (rank 0) the one-process step on the whole
    batch, compared per tensor."""
    import torch.distributed as tdist

    from maskdit_tpu_torch.train.state import StepDraws, _rows, make_train_step

    torch.cuda.set_device(0)
    res, n = 32, PARITY_DDP_BATCH
    batch, draws = parity_batch(res, n)
    rows = slice(sync.rank * n // sync.world, (sync.rank + 1) * n // sync.world)
    state, opt = train_parity_state(torch.float32, 4, res, n)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999, sync=sync)
    reset_launches()
    metrics = step(state, {k: v[rows] for k, v in batch.items()},
                   draws=StepDraws(*(_rows(d, rows) for d in draws)))
    launches = read_launches()
    other = state.params.clone() if sync.rank == 0 else state.params
    tdist.broadcast(other, src=1)
    replicas_equal = torch.equal(other, state.params)
    del other
    out = dict(replicas_equal=replicas_equal, launches=launches)
    if sync.rank != 0:  # room on the card for rank 0's one-process step
        del state, opt, step, metrics
        free_device_memory()
    else:
        ddp = dict(loss=float(metrics["loss"]), tensors=state_tensors(state))
        one_state, one_opt = train_parity_state(torch.float32, 4, res, n)
        one_metrics = make_train_step(one_opt, mask_ratio=0.5, mae_loss_coef=0.1,
                                      ema_decay=0.9999)(one_state, batch, draws=draws)
        one = state_tensors(one_state)
        rel = lambda a, b: ((a.float() - b.float()).norm()
                            / b.float().norm().clamp_min(1e-30)).item()
        errs = {k: rel(v, one[k]) for k, v in ddp["tensors"].items()}
        out.update(
            loss=abs(ddp["loss"] - float(one_metrics["loss"])) / abs(float(one_metrics["loss"])),
            grad=max(v for k, v in errs.items() if k.startswith("grad.")),
            state=max(v for k, v in errs.items() if not k.startswith("grad.")),
            worst=max(errs, key=errs.get),
        )
        log(f"[parity-ddp] 2 ranks x {n // 2} rows vs one process x {n}, DiT-XL/2 @256, fp32: "
            f"loss rel err {out['loss']:.3e}, max per-tensor gradient rel-norm err "
            f"{out['grad']:.3e}, p/ema/mu/nu {out['state']:.3e} (worst {out['worst']})")
    tdist.barrier()
    return out


def worker_train(device: str, gloo: bool) -> dict:
    """[train-ddp] / [train-ddp-nccl] in one rank: the train CLI (its
    checkpoints not written), then every rank's parameter digest."""
    import io
    import torch.distributed as tdist

    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.train import main as train_main

    world = dist.process_count()
    path = os.path.join(SCRATCH, "train-ddp-config.json")
    if dist.is_main_process():
        with open(path, "w") as f:
            json.dump(TRAIN_CONFIG, f)
    dist.barrier()
    results = os.path.join(SCRATCH, f"train-ddp-{'gloo' if gloo else 'nccl'}")
    captured = io.StringIO()
    reset_launches()
    with no_checkpoint_writes(), contextlib.redirect_stdout(captured):
        out = train_main(["--config", path, "--results_dir", results, "--device", device,
                          "--num_workers", "4", "--dist_backend", "gloo" if gloo else "nccl",
                          f"train.batchsize={DDP_BATCH // world}", *DDP_OVERRIDES])
    text = captured.getvalue()
    print(text, end="", flush=True)
    launches = read_launches()
    lines = [text.count(f"(step={s:07d}) loss=") for s in range(LOG_EVERY, DDP_STEPS + 1,
                                                                  LOG_EVERY)]
    gathered = [None] * world
    tdist.all_gather_object(gathered, (params_digest(out["state"].params), launches, lines))
    digests, counts, lines = zip(*gathered)
    history = out["history"]
    warm = history[1:]
    return dict(
        backend=tdist.get_backend(), digests=list(digests),
        launches={k: sum(c[k] for c in counts) for k in launches},
        losses=[x for r in history for x in r["losses"]],
        log_lines=[sum(per_step) for per_step in zip(*lines)],
        ms_per_step=sum(LOG_EVERY / r["steps_per_sec"] for r in warm) / (LOG_EVERY * len(warm))
        * 1e3,
    )


def phase_train_profile(tag: str = "train-profile", res: int = 32, batch: int = TRAIN_BATCH,
                        reps: int = 3, use_flash=None) -> None:
    """Device time by kernel over warm train steps at the main path's batch
    (bf16, mask 0.5), from torch.profiler."""
    from maskdit_tpu_torch.data.datasets import SyntheticLatentDataset
    from maskdit_tpu_torch.data.loader import DataLoader
    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step

    free_device_memory()
    torch.manual_seed(0)
    model = create_model("edm", img_resolution=res, img_channels=4, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1,
                         use_flash=use_flash).cuda()
    opt = make_optimizer(1e-4, batch)
    state = create_train_state(model, opt)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1)
    loader = DataLoader(SyntheticLatentDataset(batch, res, 4, 1000), batch, num_workers=4)
    host = next(iter(loader))
    batch_dev = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch_dev, gen)
    flag = "" if use_flash is None else f", use_flash={use_flash}"
    profile_device(tag, lambda: step(state, batch_dev, gen), reps,
                   f"one train step (DiT-XL/2 @{res * 8}, batch {batch}, mask 0.5, bf16{flag})")
    log(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1024 ** 3:.2f} GiB")
    del model, opt, state, step
    free_device_memory()


def conv_flops(module: torch.nn.Module, fn) -> float:
    """Operations of the Conv2d and Linear layers of ``module`` in one call
    of ``fn`` (2 per multiply-add), counted by forward hooks."""
    total = [0.0]

    def hook(m, inputs, out):
        if isinstance(m, torch.nn.Conv2d):
            total[0] += 2.0 * out.numel() * (m.in_channels // m.groups) * np.prod(m.kernel_size)
        else:
            total[0] += 2.0 * out.numel() * m.in_features

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def vae_decode_flops(vae, z: torch.Tensor) -> float:
    """Operations of ``vae.decode(z)`` per image: its convolutions and the
    mid-block attention's two products (2 * 2 * (hw)^2 * C)."""
    convs = conv_flops(vae, lambda: vae.decode(z))
    c = vae.decoder.mid.attn_1.q.in_channels
    hw = z.shape[-1] * z.shape[-2]
    return (convs + 4.0 * z.shape[0] * hw * hw * c) / z.shape[0]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.cpu() - ref).abs().max() / ref.abs().max()).item()


def check_rel(tag: str, what: str, got: torch.Tensor, ref: torch.Tensor, bound: float) -> float:
    err = rel_err(got, ref)
    log(f"[{tag}] {what}: card vs CPU max rel err {err:.3e} (bound {bound:.0e}), finite "
        f"{bool(torch.isfinite(got).all())}")
    if not (torch.isfinite(got).all() and err <= bound):
        raise AssertionError(f"{tag} {what}: {err} > {bound}")
    return err


def phase_vae() -> dict:
    """The full SD-VAE with weights ~ N(0, 0.02^2) (GroupNorm scales 1 + that)
    from seed 1, saved in the
    released ``autoencoder_kl.pth`` layout; decode of [main]'s and
    [main-512]'s latents and encode_moments of a 256-px batch on the card vs
    the same module on the CPU (fp32, TF32 off); per-image times against the
    fp32 bound, peak memory; the decode with TF32 on, once, as a measurement."""
    from maskdit_tpu_torch.models.vae import AutoencoderKL
    from maskdit_tpu_torch.sampling.generate import to_uint8
    from maskdit_tpu_torch.utils.port import load_vae

    vae = AutoencoderKL().cuda().eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in vae.parameters():
            p.normal_(0.0, 0.02, generator=g)
        # GroupNorm scales about 1, not 0.02: each norm would otherwise shrink
        # the signal 50-fold and every PNG come out mid-gray (pixel std ~3)
        for m in vae.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.add_(1.0)
    path = os.path.join(SCRATCH, "autoencoder_kl.pth")
    torch.save({k: v.cpu() for k, v in vae.state_dict().items()}, path)
    cpu = load_vae(path)
    n_params = sum(p.numel() for p in vae.parameters())
    log(f"[vae] SD-VAE (ch 128, mult 1/2/4/4), {n_params} params ~ N(0, 0.02^2) (GroupNorm "
        f"scales 1 + N(0, 0.02^2)), seed 1; "
        f"saved to {os.path.basename(path)}; torch threads {torch.get_num_threads()}")
    out = {"path": path}
    for res, sub in ((256, "samples"), (512, "samples-512")):
        z = torch.from_numpy(np.load(os.path.join(SCRATCH, sub, "latents_000000.npy")))
        zc = z.cuda()
        free_device_memory()
        got = vae.decode(zc)
        peak = torch.cuda.max_memory_allocated() / 1024 ** 3
        k = VAE_CPU_IMAGES[res]
        t0 = time.perf_counter()
        ref = cpu.decode(z[:k])
        cpu_s = time.perf_counter() - t0
        err = check_rel("vae", f"decode {tuple(z.shape)} -> {tuple(got.shape)}, its first {k} "
                        f"image(s)", got[:k], ref, VAE_REL_BOUND)
        n = z.shape[0]
        ms = cuda_ms(lambda: vae.decode(zc), 3) / n
        flops = vae_decode_flops(vae, zc)
        bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        scale = 1.0 / vae.scale_factor
        raw = lambda: vae.decoder(vae.post_quant_conv(scale * zc))
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = raw()
                tf32_ms = cuda_ms(raw, 3) / n
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        moved = float((to_uint8(tf32.cpu().numpy()) != to_uint8(got.cpu().numpy())).mean())
        log(f"[vae] decode at {res} px, batch {n}, fp32: {ms:.3f} ms/image, "
            f"{flops / 1e9:.1f} GFLOP/image, bound {bound_ms:.3f} ms/image at 67 TFLOP/s "
            f"({bound_ms / ms:.3f} of it), peak memory {peak:.2f} GiB; CPU reference "
            f"{cpu_s:.1f} s; TF32 on: {tf32_ms:.3f} ms/image, PNG values moved "
            f"{moved:.5f}, max rel change {rel_err(tf32, got.cpu()):.3e}")
        out[res] = dict(ms=ms, gflop=flops / 1e9, bound_ms=bound_ms, peak_gib=peak, err=err,
                        tf32_ms=tf32_ms, tf32_moved=moved)
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 256, 256))
                         .astype(np.float32))
    got = vae.encode_moments(x.cuda())
    out["encode_err"] = check_rel("vae", "encode_moments (2, 3, 256, 256)", got,
                                  cpu.encode_moments(x), VAE_REL_BOUND)
    del vae, cpu
    free_device_memory()
    return out


def read_pngs(folder: str, count: int, side: int) -> np.ndarray:
    """The ``{seed:06d}.png`` files of ``folder``, read by the port's codec,
    as uint8 NCHW; each must be side x side RGB."""
    from maskdit_tpu_torch.utils.png import read_png

    names = sorted(n for n in os.listdir(folder) if n.endswith(".png"))
    if names != [f"{s:06d}.png" for s in range(count)]:
        raise AssertionError(f"{folder}: PNGs {names}")
    images = np.stack([read_png(os.path.join(folder, n)) for n in names])
    if images.shape != (count, side, side, 3) or images.dtype != np.uint8:
        raise AssertionError(f"{folder}: images {images.shape} {images.dtype}")
    return images.transpose(0, 3, 1, 2)


def phase_main_png(ckpt: str, vae_path: str) -> dict:
    """The generate CLI at 256 px without --no_decode: 8 seeds, CFG 1.5, 40
    steps, decoded by [vae]'s file into PNGs; then the PNG writes alone."""
    from maskdit_tpu_torch import generate
    from maskdit_tpu_torch.sampling.generate import save_images

    outdir = os.path.join(SCRATCH, "samples-png")
    argv = [
        "--ckpt_path", ckpt, "--outdir", outdir, "--pretrained_path", vae_path,
        "--seeds", f"0-{SEEDS - 1}", "--max_batch_size", str(SEEDS),
        "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
        "--model_type", "DiT-XL/2", "--image_size", "32", "--image_channels", "4",
        "--num_classes", "1000", "--use_decoder", "True", "--mae_loss_coef", "0.1",
    ]
    reset_launches()
    result = generate.main(argv)
    launches = read_launches()
    images = read_pngs(outdir, SEEDS, 256)
    t0 = time.perf_counter()
    save_images(images.transpose(0, 2, 3, 1), range(SEEDS), os.path.join(SCRATCH, "png-writes"))
    write_ms = (time.perf_counter() - t0) / SEEDS * 1e3
    ips = result["images"] / result["seconds"]
    log(f"[main-png] {SEEDS} PNGs {images.shape[1:]} uint8, pixel mean "
        f"{float(images.mean()):.2f}, std {float(images.std()):.2f}; {result['seconds']:.3f} s: "
        f"{ips:.3f} images/s including the decode (first batch, no warm-up), decode "
        f"{result['decode_seconds']:.3f} s ({result['decode_seconds'] / SEEDS * 1e3:.1f} "
        f"ms/image); the PNG writes alone (the port's codec, zlib level 6) {write_ms:.2f} "
        f"ms/image")
    expect_launches("main-png", launches, packed_fwd=(2 * STEPS - 1) * (DEPTH + DECODER_DEPTH))
    return dict(images_per_s=ips, seconds=result["seconds"], write_ms=write_ms,
                decode_seconds=result["decode_seconds"], launches=launches, outdir=outdir)


def phase_eval(ckpt: str, vae_path: str, png_dir: str) -> dict:
    """Reference statistics of [main-png]'s PNGs (fid ref, random detector);
    eval_latent at 256 px, 16 seeds, to a finite FID against them; the
    detector on the card vs the CPU on those PNGs; the evaluator CLI on two
    npz batches; Inception ms per image."""
    import scipy

    from maskdit_tpu_torch import eval_latent, evaluator
    from maskdit_tpu_torch import fid as fid_cli
    from maskdit_tpu_torch.evals.evaluator import png_folder_to_npz
    from maskdit_tpu_torch.evals.inception import make_detector, preprocess, random_state_dict
    from maskdit_tpu_torch.utils.precision import exact_fp32

    stats = os.path.join(SCRATCH, "ref-stats.npz")
    fid_cli.main(["ref", "--data", png_dir, "--dest", stats, "--random_detector"])
    config = os.path.join(SCRATCH, "maskdit-256-eval.json")
    with open(config, "w") as f:
        json.dump({**EVAL_CONFIG_256, "eval": {**EVAL_CONFIG_256["eval"], "ref_path": stats}}, f)
    reset_launches()
    result = eval_latent.main([
        "--config", config, "--ckpt_path", ckpt, "--outdir", os.path.join(SCRATCH, "eval"),
        "--seeds", f"0-{EVAL_SEEDS - 1}", "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
        "--max_batch_size", str(SEEDS), "--num_expected", str(EVAL_SEEDS),
        "--pretrained_path", vae_path, "--random_detector"])
    launches = read_launches()
    read_pngs(result["outdir"], EVAL_SEEDS, 256)
    log(f"[eval] eval_latent: {EVAL_SEEDS} PNGs in {result['seconds']:.3f} s, FID "
        f"{result['fid']} against [main-png]'s statistics (random detector: the value only "
        f"checks the machinery)")
    if not np.isfinite(result["fid"]):
        raise AssertionError(f"eval: FID {result['fid']}")
    expect_launches("eval", launches,
                    packed_fwd=EVAL_SEEDS // SEEDS * (2 * STEPS - 1) * (DEPTH + DECODER_DEPTH))

    images = read_pngs(png_dir, SEEDS, 256)
    state = random_state_dict(0)
    card, cpu = make_detector(state, "cuda"), make_detector(state, "cpu")
    got, ref = card(images), cpu(images)
    errs = {k: check_rel("eval", f"detector {k} {got[k].shape}", torch.from_numpy(got[k]),
                         torch.from_numpy(ref[k]), INCEPTION_REL_BOUND) for k in ref}

    batches = []
    for name, folder in (("ref", png_dir), ("sample", result["outdir"])):
        batches.append(os.path.join(SCRATCH, f"{name}-batch.npz"))
        png_folder_to_npz(folder, batches[-1])
    metrics = evaluator.main([*batches, "--random_detector"])
    log(f"[eval] evaluator (scipy {scipy.__version__}): {metrics}")
    if not (len(metrics) == 5 and all(np.isfinite(v) for v in metrics.values())
            and 0 <= metrics["precision"] <= 1 and 0 <= metrics["recall"] <= 1):
        raise AssertionError(f"eval: evaluator metrics {metrics}")

    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (INCEPTION_BATCH, 3, 256, 256), dtype=np.uint8)).cuda()
    net = card.net

    def detect():
        with torch.no_grad(), exact_fp32():
            net(preprocess(x))

    ms = cuda_ms(detect, 5) / INCEPTION_BATCH
    flops = conv_flops(net, detect) / INCEPTION_BATCH
    bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    log(f"[eval] InceptionV3 at batch {INCEPTION_BATCH} (256 px -> 299), fp32: {ms:.3f} "
        f"ms/image, {flops / 1e9:.2f} GFLOP/image, bound {bound_ms:.4f} ms/image at 67 "
        f"TFLOP/s ({bound_ms / ms:.3f} of it)")
    del card, cpu, net
    free_device_memory()
    return dict(fid=result["fid"], launches=launches, stats=stats, detector_err=errs,
                metrics=metrics, inception_ms=ms, inception_gflop=flops / 1e9,
                inception_bound_ms=bound_ms)


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """An RGB uint8 image of smooth, low-frequency content: a random 7 x 9
    grid of colours, upsampled bilinearly to h x w."""
    grid = rng.uniform(0, 255, (7, 9, 3))

    def axis(n: int, size: int):
        pos = np.linspace(0, size - 1, n)
        lo = np.minimum(np.floor(pos).astype(int), size - 2)
        return lo, pos - lo

    y0, fy = axis(h, 7)
    x0, fx = axis(w, 9)
    rows = grid[y0] * (1 - fy[:, None, None]) + grid[y0 + 1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx[None, :, None]) + rows[:, x0 + 1] * fx[None, :, None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def write_image_tree(root: str, count: int, seed: int) -> list[str]:
    """``count`` PNGs in ``root/train/<class>/`` (EXTRACT_CLASSES classes,
    by index); even indices about 400 x 300, odd ones with a short side of
    at least 512, so that the crop's BOX halvings run at 256 px."""
    from maskdit_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(count):
        if i % 2 == 0:
            h, w = int(rng.integers(280, 321)), int(rng.integers(380, 421))
        else:
            short, extra = int(rng.integers(512, 641)), int(rng.integers(0, 201))
            h, w = (short, short + extra) if rng.random() < 0.5 else (short + extra, short)
        path = os.path.join(root, "train", f"n{i % EXTRACT_CLASSES:08d}", f"{i:04d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, smooth_image(rng, h, w))
        paths.append(path)
    return paths


def vae_encode_flops(vae, x: torch.Tensor) -> float:
    """Operations of ``vae.encode_moments(x)`` per image: its convolutions
    and the mid-block attention's two products (2 * 2 * (hw)^2 * C)."""
    convs = conv_flops(vae, lambda: vae.encode_moments(x))
    c = vae.encoder.mid.attn_1.q.in_channels
    hw = (x.shape[-1] // 8) * (x.shape[-2] // 8)
    return (convs + 4.0 * x.shape[0] * hw * hw * c) / x.shape[0]


def loader_rate(batches) -> float:
    """Batches per second of an iterator of batches, after its first."""
    it = iter(batches)
    next(it)
    t0 = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(it)
    return LOADER_BATCHES / (time.perf_counter() - t0)


def phase_extract(vae_path: str) -> dict:
    """The data path: 64 seeded PNGs (8 class folders) through
    ``maskdit_tpu_torch.extract_latent --resolution 256 --xflip`` on the
    card with [vae]'s weights (128 records, [train]'s data); the first 16
    through ``--resolution 512 --xflip`` (32 records), then ``lmdb2wds
    --maxcount 8`` (4 shards, [train-512]'s and [train-flash]'s data).
    Checks the native reader, the counts and ``length``, the crop against a
    direct call of the port's numpy resample, and the first image's card
    moments against a CPU fp32 encode of the same crop. Reports encode
    ms/image against the fp32 bound, the host crop, the LMDB write rate and
    the loaders' batches/s against the synthetic dataset's."""
    from maskdit_tpu_torch import extract_latent, lmdb2wds
    from maskdit_tpu_torch.data.datasets import (
        ImageNetLatentDataset,
        SyntheticLatentDataset,
        center_crop_arr,
        imagenet_lmdb_dataset,
        to_rgb,
        write_latent_lmdb,
    )
    from maskdit_tpu_torch.data.loader import DataLoader
    from maskdit_tpu_torch.data.native_io import open_reader
    from maskdit_tpu_torch.data.wds import StreamingWDSLoader, WebDatasetLatents, index_tar
    from maskdit_tpu_torch.utils.png import read_png
    from maskdit_tpu_torch.utils.port import load_vae

    images, images_512 = os.path.join(SCRATCH, "images"), os.path.join(SCRATCH, "images-512")
    for d in (images, images_512, LATENT_ROOT, TRAIN_DATA_ROOT_512):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_image_tree(images, EXTRACT_IMAGES, seed=5)
    for path in paths[:EXTRACT_IMAGES_512]:
        dest = os.path.join(images_512, os.path.relpath(path, images))
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy(path, dest)
    sizes = [read_png(p).shape[:2] for p in paths]
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    log(f"[extract] {EXTRACT_IMAGES} PNGs ({mb:.1f} MB, sides {min(min(s) for s in sizes)}-"
        f"{max(max(s) for s in sizes)} px, {sum(min(s) >= 512 for s in sizes)} with a short "
        f"side >= 512) in {EXTRACT_CLASSES} classes, written in {time.perf_counter() - t0:.1f} s")

    out = {}
    for res, root, count in ((256, images, EXTRACT_IMAGES), (512, images_512, EXTRACT_IMAGES_512)):
        free_device_memory()
        result = extract_latent.main(["--data_dir", root, "--ckpt", vae_path, "--resolution",
                                      str(res), "--xflip", "--outdir", LATENT_ROOT,
                                      "--device", "cuda"])
        db = open_reader(result["outdir"])
        length = db.get(b"length")
        log(f"[extract] extract_latent at {res} px --xflip: {result['count']} records in "
            f"{result['seconds']:.2f} s (encode {result['encode_seconds']:.2f} s), image cache "
            f"reader {result['reader']}, LMDB reader {db.kind}, length {length!r}, "
            f"{len(db)} keys")
        if (result["count"] != 2 * count or length != str(2 * count).encode()
                or len(db) != 4 * count + 1 or result["reader"] != "native"
                or db.kind != "native"):
            raise AssertionError(f"extract at {res} px: {result}, length {length!r}, "
                                 f"{len(db)} keys, reader {db.kind}")
        db.close()
        out[res] = dict(seconds=result["seconds"], encode_seconds=result["encode_seconds"])

    shards = lmdb2wds.main(["--datadir", os.path.join(LATENT_ROOT, "imagenet_512_latent_lmdb"),
                            "--outdir", TRAIN_DATA_ROOT_512, "--resolution", "64",
                            "--maxcount", str(WDS_MAXCOUNT)])
    counts = [len(index_tar(p)) for p in shards]
    log(f"[extract] lmdb2wds --maxcount {WDS_MAXCOUNT}: {len(shards)} shards of {counts} records")
    if counts != [WDS_MAXCOUNT] * (2 * EXTRACT_IMAGES_512 // WDS_MAXCOUNT):
        raise AssertionError(f"extract: shards {counts}")

    # the crop through the image cache vs a direct call; the card's moments
    # of the first image vs the CPU's
    ds = imagenet_lmdb_dataset(os.path.join(images, "train"), resolution=256)
    crop, onehot = ds[0]
    direct = center_crop_arr(to_rgb(read_png(paths[0])), 256).transpose(2, 0, 1)
    if crop.shape != (3, 256, 256) or not np.array_equal(crop, direct):
        raise AssertionError("extract: the image cache's crop differs from center_crop_arr")
    db = open_reader(os.path.join(TRAIN_DATA_ROOT, "train"))
    got = torch.from_numpy(np.frombuffer(db.get(b"z-0"), np.float32).reshape(1, 8, 32, 32).copy())
    label = int(db.get(b"y-0"))
    x0 = torch.from_numpy(crop.astype(np.float32)[None] / 127.5 - 1.0)
    cpu = load_vae(vae_path)
    out["moments_err"] = check_rel("extract", "z-0 (the card's encode) vs a CPU fp32 encode "
                                   "of the same crop", got, cpu.encode_moments(x0),
                                   VAE_REL_BOUND)
    if label != int(np.argmax(onehot)):
        raise AssertionError(f"extract: y-0 {label} != class {int(np.argmax(onehot))}")
    del cpu

    # timings: the encoder on the card, the host crop, the LMDB writer
    vae = load_vae(vae_path).cuda()
    for res, n in ((256, 16), (512, 8)):
        dsr = ds if res == 256 else imagenet_lmdb_dataset(os.path.join(images_512, "train"),
                                                          resolution=512)
        x = torch.from_numpy(np.stack([dsr[i][0] for i in range(n)]).astype(np.float32)
                             / 127.5 - 1.0).cuda()
        free_device_memory()
        ms = cuda_ms(lambda: vae.encode_moments(x), 3) / n
        peak = torch.cuda.max_memory_allocated() / 1024 ** 3
        flops = vae_encode_flops(vae, x)
        bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
        log(f"[extract] encode_moments at {res} px, batch {n}, fp32: {ms:.3f} ms/image, "
            f"{flops / 1e9:.1f} GFLOP/image, bound {bound_ms:.3f} ms/image at 67 TFLOP/s "
            f"({bound_ms / ms:.3f} of it), peak memory {peak:.2f} GiB")
        out[res].update(encode_ms=ms, gflop=flops / 1e9, bound_ms=bound_ms, peak_gib=peak)
    del vae, x
    free_device_memory()
    t0 = time.perf_counter()
    for i in range(EXTRACT_IMAGES):
        ds[i]
    item_ms = (time.perf_counter() - t0) / EXTRACT_IMAGES * 1e3
    decoded = [to_rgb(read_png(p)) for p in paths]
    t0 = time.perf_counter()
    for arr in decoded:
        center_crop_arr(arr, 256)
    crop_ms = (time.perf_counter() - t0) / EXTRACT_IMAGES * 1e3
    moments = np.stack([np.frombuffer(db.get(f"z-{i}".encode()), np.float32)
                        for i in range(2 * EXTRACT_IMAGES)]).reshape(-1, 8, 32, 32)
    db.close()
    t0 = time.perf_counter()
    write_path = os.path.join(SCRATCH, "write-test")
    write_latent_lmdb(write_path, moments, np.arange(len(moments)) % EXTRACT_CLASSES)
    write_mb_s = os.path.getsize(os.path.join(write_path, "data.mdb")) / 1e6 / (
        time.perf_counter() - t0)
    log(f"[extract] host (the card's machine, {os.cpu_count()} cores): PNG decode + crop to "
        f"256 px {item_ms:.2f} ms/image through the image cache, the crop alone "
        f"{crop_ms:.2f} ms/image; latent LMDB write "
        f"{write_mb_s:.1f} MB/s ({len(moments)} records of 32 KiB)")
    out.update(item_ms=item_ms, crop_ms=crop_ms, write_mb_s=write_mb_s)

    rates = {}
    for name, make in (
        ("lmdb native", lambda: ImageNetLatentDataset(TRAIN_DATA_ROOT, 32)),
        ("lmdb python", lambda: ImageNetLatentDataset(TRAIN_DATA_ROOT, 32, native=False)),
        ("synthetic", lambda: SyntheticLatentDataset(2 * EXTRACT_IMAGES, 32)),
    ):
        rates[name] = loader_rate(DataLoader(make(), TRAIN_BATCH, num_workers=4))
    for name, make in (
        ("wds indexed", lambda: DataLoader(WebDatasetLatents(TRAIN_DATA_ROOT_512), TRAIN_BATCH_512,
                                           num_workers=4)),
        ("wds streaming", lambda: StreamingWDSLoader(TRAIN_DATA_ROOT_512, TRAIN_BATCH_512)),
        ("synthetic 512", lambda: DataLoader(SyntheticLatentDataset(2 * EXTRACT_IMAGES_512, 64),
                                             TRAIN_BATCH_512, num_workers=4)),
    ):
        rates[name] = loader_rate(make())
    log(f"[extract] loader batches/s over {LOADER_BATCHES} batches (4 worker threads): batch "
        f"{TRAIN_BATCH} at 32 x 32 " + ", ".join(f"{k} {v:.2f}" for k, v in list(rates.items())[:3])
        + f"; batch {TRAIN_BATCH_512} at 64 x 64 "
        + ", ".join(f"{k} {v:.2f}" for k, v in list(rates.items())[3:]))
    out["loader_batches_per_s"] = rates
    return out


def phase_overfit_gate() -> dict:
    """tools/torch_overfit_gate.py at its defaults on the card (2000 fp32
    steps of the tiny DiT-S/2, 18-step sampler, 8 classes); fails unless
    the verdict passes. Its launches: per step 4 encoder + 2 decoder
    attention calls forward and backward and one update; per class 35
    evaluations of 6 attention calls."""
    from tools.torch_overfit_gate import run_gate

    free_device_memory()
    reset_launches()
    t0 = time.perf_counter()
    verdict = run_gate(out=os.path.join(SCRATCH, "overfit-gate"), device="cuda")
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"[overfit-gate] {json.dumps(verdict)}; {seconds:.1f} s")
    if not verdict["passed"]:
        raise AssertionError(f"overfit-gate: {verdict}")
    steps, blocks, classes, evals = 2000, 4 + 2, 8, 2 * 18 - 1
    expect_launches("overfit-gate", launches, packed_fwd=steps * blocks + classes * evals * blocks,
                    packed_bwd=steps * blocks, adam=steps)
    return dict(verdict=verdict, seconds=seconds, launches=launches)


def kernel_line(name: str, source: str, replaces: str, launches: int, err: float,
                row: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"maskdit_tpu_torch/ops/csrc/{source}",
            "replaces": f"maskdit_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")}


def main() -> None:
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    smi = phase_device()
    phase_build()
    mark("build")
    kernels = phase_kernels()
    bwd = phase_bwd_kernels()
    adam = phase_adam_kernel()
    big = phase_big_kernels()
    flash_k = phase_flash_kernels()
    mark("kernel rows")
    try:
        ckpt = phase_weights()
        main_path = phase_main(ckpt)
        parity = phase_model_parity(ckpt)
        main_512 = phase_main_512(ckpt)
        parity_512 = phase_model_parity(ckpt, "parity-512", 64, SEEDS_512, ("kernel",))
        mark("sampling")
        vae = phase_vae()
        mark("vae")
        extract = phase_extract(vae["path"])
        mark("extract")
        main_png = phase_main_png(ckpt, vae["path"])
        mark("main-png")
        evals = phase_eval(ckpt, vae["path"], main_png["outdir"])
        mark("eval")
        train = phase_train(vae["path"], evals["stats"])
        parity_train = phase_parity_train()
        phase_train_profile()
        mark("train (with train-eval)")
        parity_options = phase_parity_train_options()
        train_options = phase_train_options(train)
        mark("train-options")
        parity_ddp = phase_parity_ddp()
        train_ddp = phase_train_ddp()
        train_ddp_nccl = phase_train_ddp_nccl()
        mark("data parallel")
        train_512 = run_train("train-512", TRAIN_CONFIG_512, 64, dict(
            big_fwd=ATTN_PER_STEP, big_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP))
        parity_train_512 = phase_parity_train("parity-train-512", 64, PARITY_BATCH_512)
        phase_train_profile("train-profile-512", 64, TRAIN_BATCH_512, 2)
        mark("train-512")
        parity_flash = phase_flash_parity(ckpt)
        # the checkpoint recomputes each layer's forward in the backward
        train_flash = run_train("train-flash", TRAIN_CONFIG_512, 64, dict(
            flash_fwd=2 * ATTN_PER_STEP, flash_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP),
            ("model.use_flash=true", "data.streaming=true",
             f"train.max_num_steps={TRAIN_STEPS_FLASH}"))
        parity_train_flash = phase_parity_train("parity-train-flash", 64, PARITY_BATCH_512,
                                                use_flash=True)
        phase_train_profile("train-profile-flash", 64, TRAIN_BATCH_512, 2, use_flash=True)
        mark("train-flash")
        gate = phase_overfit_gate()
        mark("overfit-gate")
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[summary] {smi}: sampling 256 {main_path['images_per_s']:.3f} images/s (cold), "
        f"warm {parity['sampling']['kernel']}; sampling 512 {main_512['images_per_s']:.3f} "
        f"(cold), warm {parity_512['sampling']['kernel']}; model rel err 256 bf16 "
        f"{parity['bfloat16']:.3e}, fp32 {parity['float32']:.3e}, 512 bf16 "
        f"{parity_512['bfloat16']:.3e}, fp32 {parity_512['float32']:.3e}; training 256 "
        f"{train['images_per_s']:.2f} images/s, MFU {train['mfu']:.4f}, peak "
        f"{train['peak_gib']:.2f} GiB; training 512 {train_512['images_per_s']:.2f} images/s, "
        f"MFU {train_512['mfu']:.4f}, peak {train_512['peak_gib']:.2f} GiB; train parity "
        f"{parity_train}; train parity 512 {parity_train_512}; use_flash: model rel err "
        f"bf16 {parity_flash['bfloat16']:.3e}, fp32 {parity_flash['float32']:.3e}; training "
        f"{train_flash['images_per_s']:.2f} images/s, {train_flash['ms_per_step']:.1f} ms/step, "
        f"MFU {train_flash['mfu']:.4f}, peak {train_flash['peak_gib']:.2f} GiB; train parity "
        f"{parity_train_flash}; evaluation: VAE decode {vae[256]['ms']:.3f} ms/image at 256 px, "
        f"{vae[512]['ms']:.3f} at 512, sampling 256 with the decode {main_png['images_per_s']:.3f} "
        f"images/s (cold), InceptionV3 "
        f"{evals['inception_ms']:.3f} ms/image, eval_latent FID "
        f"{evals['fid']:.4f}, train-eval FID {train['eval_fid']:.4f} (random weights); data: "
        f"encode {extract[256]['encode_ms']:.3f} / {extract[512]['encode_ms']:.3f} ms/image at "
        f"256 / 512 px, host crop {extract['crop_ms']:.2f} ms/image, LMDB write "
        f"{extract['write_mb_s']:.1f} MB/s, loader batches/s {extract['loader_batches_per_s']}; "
        f"overfit gate {gate['verdict']} in {gate['seconds']:.1f} s; fused adam ms "
        f"{ {adam_variant_name(v): round(adam[v]['ms'], 4) for v in ADAM_VARIANTS} }; "
        f"train-options {train_options['images_per_s']:.2f} images/s, "
        f"{train_options['ms_per_step']:.1f} ms/step, peak {train_options['peak_gib']:.2f} GiB, "
        f"parity {parity_options}; parity-ddp loss {parity_ddp['loss']:.3e} grad "
        f"{parity_ddp['grad']:.3e} state {parity_ddp['state']:.3e}; train-ddp (2 gloo ranks "
        f"on one card) {train_ddp['ms_per_step']:.1f} ms/step; train-ddp-nccl bit for bit; "
        f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    bf16 = lambda rows, names: max(rows[(n, "bfloat16")]["err"] for n in names)
    paths = (main_path, train, main_512, train_512, train_flash, main_png, evals, gate,
             train_options, train_ddp, train_ddp_nccl, train_ddp_nccl["alone"])
    count = lambda key: sum(p["launches"][key] for p in paths)
    print(json.dumps({"kernels": [
        kernel_line("packed_attention_fwd", "packed_attention_fwd.cu", "flash_batched.py:162",
                    count("packed_fwd"), bf16(kernels, [s[0] for s in ATTN_FWD_SHAPES]),
                    kernels[("encoder", "bfloat16")]),
        kernel_line("packed_attention_bwd", "packed_attention_bwd.cu", "flash_batched.py:177",
                    count("packed_bwd"), bf16(bwd, ["train_encoder", "train_decoder"]),
                    bwd[("train_encoder", "bfloat16")]),
        kernel_line("fused_adam_ema", "fused_adam_ema.cu", "fused_adam.py:109", count("adam"),
                    adam[ADAM_VARIANTS[0]]["err"], adam[ADAM_VARIANTS[0]]),
        kernel_line("packed_attention_big_fwd", "packed_attention_big_fwd.cu",
                    "flash_big.py:213", count("big_fwd"),
                    bf16(big["fwd"], [s[0] for s in BIG_FWD_SHAPES]),
                    big["fwd"][("sample_encoder", "bfloat16")]),
        kernel_line("packed_attention_big_bwd", "packed_attention_big_bwd.cu",
                    "flash_big.py:234", count("big_bwd"),
                    bf16(big["bwd"], ["train_encoder", "train_decoder"]),
                    big["bwd"][("train_encoder", "bfloat16")]),
        kernel_line("flash_fwd", "flash_fwd.cu", "flash.py:96", count("flash_fwd"),
                    bf16(flash_k["fwd"], ["train_encoder", "train_decoder"]),
                    flash_k["fwd"][("train_encoder", "bfloat16")]),
        kernel_line("flash_bwd", "flash_bwd.cu", "flash.py:114", count("flash_bwd"),
                    bf16(flash_k["bwd"], ["train_encoder", "train_decoder"]),
                    flash_k["bwd"][("train_encoder", "bfloat16")]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:])
    else:
        main()
