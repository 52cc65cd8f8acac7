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
     the unmasked 256-px encoder's, where one attention layer's route (the
     whole-row kernels) is checked on the card; every bf16 tensor-core
     kernel (the whole-row forward #1, the blocked and flash forwards #3
     and #5, csrc/attention_fwd_mma.cuh, both packed backwards #2 and #4,
     csrc/attention_bwd_mma.cuh, and the flash backward #6) at every head
     dim that is a multiple of 8 from 8 to 128; each row of #1-#4 and #6
     names the kernels that ran (mma, mma6 or fma), and a bf16 row of any
     of them, or an fp32 row of #1-#4, at such a head dim that is not on
     the tensor cores (mma, mma6) fails;
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
     bf16 (since [remat] came at FLASH_DEPTH encoder blocks); a profile of
     one train step;
  7. training at 512 px: the same CLI on the released 512-px config at its
     batch of 32, cut to 8 steps, on [extract]'s WebDataset shards
     (indexed), 36 + 36 blocked-attention launches and
     one fused-update launch per step; train-step parity (at FLASH_DEPTH
     encoder blocks since [remat] came); a profile;
  8. the ``use_flash`` path (ops/flash.py, kernels #5 and #6): both kernels
     against their plain versions at every L of their window (bf16 and
     fp32, head dims 32, 64, 72) and, in fp32 (the tensor-core kernels of
     csrc/attention_fp32_mma.cuh, 'mma6'), at every head dim that is a
     multiple of 8 from 8 to 128, then timed at the 512-px shapes, at the
     edges of the window and at an odd head dim, and in fp32 at the
     unmasked finetunes' shapes; then, on DiT-XL/2 at full width
     with FLASH_DEPTH (4) of its 28 encoder blocks: one CFG denoiser
     evaluation at 512 px with ``use_flash=True``, kernels vs plain; the
     train CLI on the released 512-px config with the overrides
     ``model.use_flash=true`` and ``data.streaming=true`` (the shards
     streamed), at batch 32, cut to 6 steps: 24 flash-forward launches (the
     checkpoint recomputes each layer's forward in the backward), 12
     flash-backward and one fused-update launch per step; train-step
     parity kernels vs plain and, in fp32, flash vs the blocked kernels; a
     profile;
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
     the whole-row attention and the update count in the kernels line.
     Since the tool twins came it runs in a process of its own
     (``worker_alone``) beside 13. and [validate-port];
 12. the train-step options (after 6.): [kernel] fused adam in every
     variant of ADAM_VARIANTS (a bf16 gradient, bf16 mu and nu, the EMA
     off), the new ones bit for bit with the plain version (nu's
     stochastic rounding by Philox4x32-10 included), and the rounding's
     statistics over 2^20 values; [parity-train-options] one bf16 step
     with amp_grads, a bf16 accumulator over 2 micro-batches, bf16 mu and
     nu and ema_every 2, kernels vs plain (and kernel #7 bit for bit on the
     step's own gradient); [train-options] the train CLI with those
     options at a global batch of 2 x 64, 8 steps, one update per step and
     an attention launch per block and micro-batch each way (since the
     tool twins came at FLASH_DEPTH encoder blocks: 24 + 24), beside
     [train]'s times. Since the tool twins came the parity steps of 12.
     and 16. run beside the background group of 18., and since [remat]
     came at FLASH_DEPTH encoder blocks (launches scaled);
 13. data parallelism on the one card, each phase a ``torch.distributed.run``
     of this script's workers (``--worker TAG``), on DiT-XL/2 at full width
     with DDP_DEPTH of its 28 encoder blocks (4 until remat came to the
     mesh, 2 since): [parity-ddp] two gloo
     ranks, one fp32 step on an injected global batch of 32: the replicas
     equal bit for bit and within [parity-train]'s fp32 bounds of one
     process's step; [train-ddp] the train CLI in two gloo ranks sharing
     the card, 4 steps at a global batch of 64: finite losses, one log line
     per logged step (rank 0's), equal parameter digests; [train-ddp-nccl]
     one NCCL rank against the same 4 steps without a process group: equal
     bit for bit. These CLI runs write no checkpoint (a call may write 45
     GiB; [train] holds the writes and the resume). Beside them, in one
     launch of MESH_RANKS gloo ranks at the same depth, [parity-mesh] (each
     MESH_PARITY case, remat and use_flash among them, against one
     process's step) and [train-mesh] (the train CLI's ``--mesh``);
 14. the finetune phase (configs/finetune/*.yaml, fp32, as the released
     scripts/finetune_latent512.sh runs it: ``--ckpt_path X.pt
     --use_strict_load False``): [kernel-fp32] (with 3.) the fp32 attention
     kernels the route takes at the finetune shapes, (64, 256, 16, 72 / 32),
     (16, 1024, 16, 72 / 32) and the cos4 buckets (64, 128 / 224 / 240, 16,
     72), forward and backward against their plain versions and SDPA, and
     both fp32 pairs (#1 / #2, #3 / #4, csrc/attention_fp32_mma.cuh) at
     every head dim that is a multiple of 8 from 8 to 128;
     [train-finetune256], [train-finetune-cos] and
     [train-finetune512] the train CLI on the three YAMLs at their batches
     (64, 64, 16), full width and depth, 6, 6 and 4 steps, and
     [train-finetune512-flash] the 512-px one again with
     ``model.use_flash=true`` (72 flash forwards, 36 flash backwards in
     fp32 and one update per step, no other attention kernel), each importing
     [weights]' tensors from a reference .pt without the mask token: finite
     losses, each step's route launches (the cos4 run's kept tokens change
     per step: 128, 144, 176, 224, 240, 240, held to the schedule) and one
     update, TF32 off, the import non-strict with the mask token at its
     initialisation and every other parameter equal to the file's; MFU
     beside the share of the fp32 peak; [parity-train-finetune] one fp32
     step kernels vs plain at mask 0 and at a cos4 bucket, and the
     pad-to-max step against the packed step at that ratio;
     [parity-train-finetune-flash] one fp32 step of the 512-px model with
     ``use_flash`` at mask 0 (FLASH_DEPTH encoder blocks), kernels vs plain
     and against the blocked kernels' step; a profile of one step of each
     unmasked finetune and of the flash one. These runs write no checkpoint;
 15. the model corners (after 14., at DiT-XL/2's full width with FLASH_DEPTH
     of its 28 encoder blocks, ``xl_depth``):
     the class-token lengths' kernel rows (with 3. and 14.: #1 at (16, 257,
     16, 72) and (128, 129, 16, 72), #2 at the latter, #3 / #4 at (64,
     257, 16, 72), in bf16 and fp32); [sample-cls] the generate CLI on
     configs/test/maskdit-256.yaml's model with ``pad_cls_token`` and
     ``self_cond`` (8 seeds, CFG 1.5, 40 steps; each evaluation runs the
     encoder for the pooled feature, then the model: 4 + 4 whole-row
     forwards at L 257 and 8 at L 256), and one CFG evaluation kernels vs
     plain in bf16 and fp32; [train-cls-feat] the train CLI on the released
     256-px config with a class token and FEATURE_DIM-wide features joined
     from a feature LMDB this script writes beside [extract]'s latents
     (batch 128, mask 0.5, 4 steps): finite losses, 12 + 12 whole-row
     launches (the encoder at 129 tokens) and one update per step, the
     features reaching the model at every step; [parity-cls] one fp32 step
     of that model kernels vs plain at mask 0.5 (L 129, #1 / #2) and mask 0
     (L 257, #3 / #4), each kernel step checked to the launch;
 16. the staged update (``train.fused_adam: false``, plain PyTorch; after
     12.): [train-staged] the train CLI on the released 256-px config with
     that override, batch 128, 6 steps (since the tool twins came at
     FLASH_DEPTH encoder blocks): finite losses, one whole-row launch per
     block each way and no launch of kernel #7 per step;
     [train-staged-nu] the same with bf16 mu and nu (the stochastically
     rounded nu of ``adam_sr_nu``), 4 steps, the moments stored in bf16;
     [train-staged-profile] one fp32 staged update over all 730M
     parameters, its device ms beside #7's; [parity-train-staged] one fp32 step
     of the parity model, staged against the fused kernel's step (the same
     gradients) within the fp32 training bounds, and the card's staged
     update against the same on a CPU copy of its inputs;
 17. the sampler export (after 5.): [aot] sample256's sampler (bf16, CFG
     1.5, batch 8, S_churn AOT_CHURN) exported by the generate
     CLI's ``--export_aot`` at AOT_STEPS, and [aot-512] / [aot-flash] the
     512-px and ``use_flash`` ones at FLASH_DEPTH encoder blocks by
     ``sampling/aot.export_sampler``; then a fresh process that imports
     only torch and ``maskdit_tpu_torch.ops`` reloads each file with
     ``ops/exported.load_sampler`` and samples with the live sampler's
     weights, inputs and churn noise (``LoadedSampler.churn_noise`` from a
     CUDA generator seeded alike): no model or sampling module in it,
     one launch of the op's kernel (#1, #3, #5) per attention layer and
     evaluation, counted there, the output within MODEL_REL_BOUND of the
     live sampler's; export seconds, file MB, reload seconds and warm
     images/s beside the live sampler's. Since the tool twins came,
     [aot] runs at FLASH_DEPTH encoder blocks too (a reference .pt of
     [weights]' first blocks through the CLI), for the script's time;
 18. the tool and script twins: [validate-port] (after 13.)
     tools/torch_validate_port.py on a reference-layout DiT-XL/2 file
     whose model and ema differ, at 256 px with ``--sample`` and [vae]'s
     file and at 512 px: every key consumed, nothing non-finite, an EMA
     delta > 0, each sigma row finite and within MODEL_REL_BOUND[bf16] of
     the same table on the plain attention, its #1 / #3 launches;
     [fid-gate-dry] and [smoke-pipeline] scripts/torch_fid_parity_gate.sh
     --dry-wire and scripts/torch_smoke_pipeline.sh with DEVICE=cuda, in
     processes of their own beside the parity steps of 12. and 16., 13. and
     [validate-port], whose results are checks (their launches
     are their processes', uncounted here): exit 0, their closing lines, a
     finite FID, 8 PNGs; [mu-curve] tools/torch_mu_dtype_curve.py's run
     (four processes of their own beside the same, launches counted there)
     and report for mu, nu and munu at 200 steps against one fp32 run: the
     JAX tool's report keys, finite losses, one #7 launch per step, a
     divergence guard; [trace] tools/torch_trace_capture.py in
     train mode at [train-profile]'s batch and in sample mode, each trace
     read by tools/torch_trace_report.py: the port's kernels among its
     categories, the train step's device ms within 10% of
     [train-profile]'s busy ms, ``device_memory_stats`` against the
     allocator; [attn-bench] tools/torch_attn_bench.py with its three
     implementations: every row timed or refused, only the JAX window's
     refusals, the kernels' launches;
 19. [remat] (after 6.) the JAX model's activation rematerialisation
     (models/remat.py) on 6.'s model at full depth and width, bf16, mask
     0.5, batch 128: one train step per policy (none, full, dots, names,
     names_lite) from one state with the same draws, each against the step
     without remat (bit for bit expected, else within the bf16 training
     bounds), 36 + 36 whole-row launches without remat and 72 + 36 under
     each policy (every block's attention forward reruns in the backward),
     one update; peak memory and ms/step (CUDA events); then one step under
     'full' at batch 512, 4x the released per-device batch: a finite loss,
     its launches and peak; [remat-512] the same per policy on train512's
     model (full depth, batch 32: 36 + 36 blocked launches, 72 + 36 under a
     policy) and [remat-flash] on train512-flash's (FLASH_DEPTH encoder
     blocks, ``use_flash``: 24 + 12 flash launches with and without remat,
     the block's recompute taking the place of the layer's checkpoint).

Before each main path the launch counts are set to 0 and read just after:
a path fails if a kernel it should run was not launched, or one it should
not run was. The line before the last is a JSON object of the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
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
# the class token's lengths (model.pad_cls_token: the encoder one token
# longer), where the JAX package runs plain attention and the port its
# kernels with ragged tiles (ROADMAP C7): #1 at the CFG sampling encoder's
# L 257 and the masked training encoder's 128 kept tokens + 1 (with #2
# there), #3 / #4 at the unmasked training encoder's L 257 (batch 64). Each
# runs in bf16 with the [kernel] / [kernel-big] rows and in fp32 with the
# [kernel-fp32] rows
CLS_FWD_SHAPES = [("cls_sample_encoder", 2 * SEEDS, 257, 16, 72),
                  ("cls_train_encoder", TRAIN_BATCH, 129, 16, 72)]
CLS_BWD_SHAPES = CLS_FWD_SHAPES[1:]
CLS_BIG_SHAPES = [("cls_unmasked_encoder", 64, 257, 16, 72)]
# the masked training path on the mesh's tensor axis of 2: each rank's
# attention at 8 of the 16 heads (#1 forward, #2 backward; bf16)
MESH_ATTN_SHAPES = [("mesh_train_encoder", TRAIN_BATCH, 128, 8, 72),
                    ("mesh_train_decoder", TRAIN_BATCH, 256, 8, 32)]
# kernel vs plain bound on max|kernel - plain| / max|plain| of the forward:
# fp32 differs by summation order (the fp32 blocked kernels on the tensor
# cores also by their dropped terms, ~2^-24 of each product, and the
# mma.sync accumulation: at most 3.3e-6 measured); bf16 where that order
# flips one rounding of p or of the output, by one bf16 ulp, at most 2^-7
# of the largest value
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
# 64, L 256), which the route sends to the whole-row kernels, as the JAX
# package does: the blocked kernels' rows there are a yardstick for those.
# The backward at the training shapes and a ragged one (L not a multiple of
# the 32-row blocks or the 64-row tiles, hd 40). The bounds are
# FWD_REL_BOUND and BWD_REL_BOUND.
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
# the whole-row kernels (#1 in bf16; #1 and #2 in fp32) over the same head
# dims at an L their route takes at every one of them
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
# [parity-flash], [train-flash], [parity-train-flash] and
# [train-profile-flash] check the flag's route, launches and parity, not
# the model's depth: since the model corners' phases came they run DiT-XL/2
# at full width with FLASH_DEPTH of its 28 encoder blocks (the 8 decoder
# blocks kept), for the script's time (``xl_depth``)
FLASH_DEPTH = 4
FLASH_ATTN_PER_STEP = FLASH_DEPTH + DECODER_DEPTH

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
# [remat]: train256's step (DiT-XL/2 at full depth and width, bf16, mask 0.5,
# batch TRAIN_BATCH) under each of the JAX model's remat policies from one
# state with the same draws, against the step without remat (bit for bit
# expected, else TRAIN_PARITY_BOUND[bf16]); each policy reruns every block's
# attention forward in the backward; then 'full' at
# REMAT_BIG_BATCH, 4x the released per-device batch; [remat-512] and
# [remat-flash] alike on the blocked and flash routes (``phase_remat``)
REMAT_POLICIES = ("none", "full", "dots", "names", "names_lite")
REMAT_TIMED_STEPS = 1
REMAT_BIG_BATCH = 4 * TRAIN_BATCH
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
# these three phases and the mesh's check the replicas, the collectives and
# the shards, not the model's depth: they run DiT-XL/2 at full width with
# DDP_DEPTH of its 28 encoder blocks (the 8 decoder blocks kept), for the
# script's time (``xl_depth``; 4 until the mesh's remat cases came)
DDP_DEPTH = 2
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
# the finetune phase (the reference recipe's second phase,
# scripts/finetune_latent512.sh): configs/finetune/*.yaml as JSON, fp32,
# with data.root at [extract]'s latent LMDB (256 px) or shards (512 px) and
# the cuts FINETUNE_CUTS lists: a few steps, each logged (the cos4 run's
# max_num_steps is its length, so that its schedule crosses several
# buckets). Each run imports FINETUNE_CKPT, [weights]' tensors as a
# reference .pt whose model and ema lack the mask token, as the released
# command does: --ckpt_path X.pt --use_strict_load False.
# tests/test_torch_trainer.py holds the rest equal to the YAMLs
FINETUNE_STEPS, FINETUNE_STEPS_512 = 6, 4
FINETUNE_BATCH, FINETUNE_BATCH_512 = 64, 16
FINETUNE_CKPT = os.path.join(SCRATCH, "random-xl2-finetune.pt")
FINETUNE_CONFIG = {
    "data": TRAIN_CONFIG["data"],
    "model": {**TRAIN_CONFIG["model"], "mask_ratio": 0.0},
    "train": {"fp32": True, "batchsize": FINETUNE_BATCH, "grad_accum": 1, "epochs": 1000,
              "lr": 0.00005, "lr_rampup_kimg": 0, "xflip": False,
              "max_num_steps": FINETUNE_STEPS},
    "log": {"log_every": 1, "ckpt_every": 12500, "tag": "chip-smoke-finetune-const"},
}
FINETUNE_COS_CONFIG = {
    **FINETUNE_CONFIG,
    "model": {**TRAIN_CONFIG["model"], "mask_ratio_fn": "cos4"},
    "log": {"log_every": 1, "ckpt_every": 12500, "tag": "chip-smoke-finetune-cos"},
}
FINETUNE_CONFIG_512 = {
    "data": {"dataset": "imagenet512-latent", "category": "webdataset", "resolution": 64,
             "num_channels": 4, "root": TRAIN_DATA_ROOT_512, "total_num": 1281167},
    "model": {**FINETUNE_CONFIG["model"], "in_size": 64},
    "train": {**FINETUNE_CONFIG["train"], "batchsize": FINETUNE_BATCH_512, "epochs": 2000,
              "max_num_steps": FINETUNE_STEPS_512},
    "log": {"log_every": 1, "ckpt_every": 10000, "tag": "chip-smoke-finetune-512"},
}
# each config's YAML (configs/finetune/imagenet<name>.yaml) and its cuts
FINETUNE_CONFIGS = {
    "256-latent-const": (FINETUNE_CONFIG, {"train.max_num_steps": (100000, FINETUNE_STEPS)}),
    "256-latent-cos": (FINETUNE_COS_CONFIG, {"train.max_num_steps": (100000, FINETUNE_STEPS)}),
    "512-latent": (FINETUNE_CONFIG_512, {"train.max_num_steps": (50000, FINETUNE_STEPS_512)}),
}
# [parity-train-finetune]'s cos4 bucket: the 256-px cos run's step 3 of 6
# (ratio 0.125 after bucketing, 224 of 256 tokens kept)
FINETUNE_PARITY_STEP = 3
# [kernel-fp32]: the finetune paths' attention shapes, (name, N, L, heads,
# head dim): the unmasked encoder and the decoder at 256 px (batch 64) and
# at 512 px (batch 16), and the cos4 run's encoder buckets at 128, 224 and
# 240 kept tokens, each timed in fp32 on the kernels the route takes with a
# backward
FINETUNE_ATTN_SHAPES = [
    ("finetune256_encoder", FINETUNE_BATCH, 256, 16, 72),
    ("finetune256_decoder", FINETUNE_BATCH, 256, 16, 32),
    ("finetune512_encoder", FINETUNE_BATCH_512, 1024, 16, 72),
    ("finetune512_decoder", FINETUNE_BATCH_512, 1024, 16, 32),
    ("finetune_cos_encoder_128", FINETUNE_BATCH, 128, 16, 72),
    ("finetune_cos_encoder_224", FINETUNE_BATCH, 224, 16, 72),
    ("finetune_cos_encoder_240", FINETUNE_BATCH, 240, 16, 72),
]
# [train-finetune512-flash]: the 512-px finetune (FINETUNE_CONFIG_512,
# its cuts) with the CLI override FINETUNE_FLASH_OVERRIDES, the key both
# packages read (the YAML leaves it unset): every attention layer takes the
# flash kernels #5 / #6 in fp32 at full width and depth, 2 forwards (the
# checkpoint's recompute) and 1 backward per layer and step.
# [parity-train-finetune-flash]: one fp32 step of that model at mask 0,
# FLASH_DEPTH encoder blocks, batch PARITY_BATCH_512: kernels vs plain and
# flash vs the blocked kernels #3 / #4. FLASH_FP32_SHAPES: the flash
# kernels' fp32 rows at the unmasked finetunes' shapes (512 px and 256 px
# with the flag)
FINETUNE_FLASH_OVERRIDES = ("model.use_flash=true",)
FLASH_FP32_SHAPES = FINETUNE_ATTN_SHAPES[:4]
# bf16 products per fp32 product in the fp32 tensor-core kernels (#1-#4:
# csrc/attention_fp32_mma.cuh); an fp32 row prints, beside the fp32 FMA
# bound, the tensor cores' bound of that scheme (FP32_TERMS x the products
# at 989 TFLOP/s)
FP32_TERMS = 6
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
# the model corners at DiT-XL/2's full width; since the staged-update and
# export phases came, with FLASH_DEPTH of its 28 encoder blocks (the 8
# decoder blocks kept) for the script's time (no released config
# sets these keys). [sample-cls]: configs/test/maskdit-256.yaml's model with
# a class token and self-conditioning (model.self_cond: each evaluation
# first runs the encoder for its pooled feature), from [weights]' tensors
# and seeded N(0, 0.02^2) ones for the class token and its two embedders
# (CLS_CKPT). [train-cls-feat]: TRAIN_CONFIG with a class token and
# external features of FEATURE_DIM floats (a stated width, a ViT-B
# feature's), read from a feature LMDB written beside [extract]'s latents,
# N(0, 1) from FEATURE_SEED, its labels the latents'; TRAIN_STEPS_CLS steps
# at the released batch of 128, mask 0.5, no checkpoint written.
# [parity-cls]: that model's fp32 step at PARITY_BATCH, kernels vs plain, at
# mask 0.5 and 0
SAMPLE_CLS_CONFIG = {"model": {**EVAL_CONFIG_256["model"], "pad_cls_token": True,
                               "self_cond": True}}
CLS_CKPT = os.path.join(SCRATCH, "random-xl2-cls.pt")
FEATURE_DIM, FEATURE_SEED, TRAIN_STEPS_CLS = 768, 0, 4
FEATURE_ROOT = os.path.join(SCRATCH, "features")
TRAIN_CLS_CONFIG = {
    "data": {**TRAIN_CONFIG["data"], "feat_path": FEATURE_ROOT},
    "model": {**TRAIN_CONFIG["model"], "pad_cls_token": True, "ext_feature_dim": FEATURE_DIM},
    "train": {**TRAIN_CONFIG["train"], "max_num_steps": TRAIN_STEPS_CLS},
    "log": {"log_every": LOG_EVERY, "ckpt_every": 50000, "tag": "chip-smoke-cls-feat"},
}
CLS_MODEL_KW = dict(pad_cls_token=True, ext_feature_dim=FEATURE_DIM)
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
DDP_ATTN_PER_STEP = DDP_DEPTH + DECODER_DEPTH
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
# the mesh (--mesh data=a,fsdp=b,tensor=c; parallel/mesh.py, sharded.py):
# MESH_RANKS gloo ranks sharing the card (``--device cuda:0``), DiT-XL/2 at
# full width and DDP_DEPTH encoder blocks, in one launch beside the
# data-parallel group. [parity-mesh]: one fp32 step (TF32 off) from
# train_parity_state's state and parity_batch's draws per MESH_PARITY case,
# each against one process's step within TRAIN_PARITY_BOUND (a bf16 nu:
# within one bf16 ulp, or the bf16 bounds with a bf16 model); [train-mesh]:
# the train CLI with --mesh MESH_TRAIN for MESH_TRAIN_STEPS steps at a
# global batch of MESH_TRAIN_BATCH x ranks, its checkpoint resumed in this
# process without a group
# The cases under remat (and the one with use_flash) each follow the case of
# the same mesh without them, which they are also held to bit for bit
# (MESH_SAME_AS); every case times its step and reads its rank's memory at
# the start and at the end of the backward (each block's unit released by
# then, after its gradient's reduction) and the step's peak, and holds the
# units' buffers alive at once to the root and the two largest blocks
MESH_RANKS = 4
F2T2, D2F2 = {"fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 2}
MESH_PARITY = [  # (case, res, batch, mesh, model dtype, nu dtype, remat, use_flash)
    ("fsdp2-tensor2", 32, PARITY_BATCH, F2T2, torch.float32, None, None, None),
    # under 'full' the backward reruns the tensor group's sums of proj and fc2
    ("fsdp2-tensor2-full", 32, PARITY_BATCH, F2T2, torch.float32, None, "full", None),
    ("data2-fsdp2", 32, PARITY_BATCH, D2F2, torch.float32, None, None, None),
    # the recompute reruns qkv's and fc1's GEMMs after the unit's gather
    ("data2-fsdp2-names_lite", 32, PARITY_BATCH, D2F2, torch.float32, None, "names_lite",
     None),
    ("fsdp2-tensor2-512", 64, PARITY_BATCH_512, F2T2, torch.float32, None, None, None),
    ("fsdp2-tensor2-512-dots", 64, PARITY_BATCH_512, F2T2, torch.float32, None, "dots", None),
    # #5 / #6 at the mesh's 8 local heads (a route the JAX dispatch does
    # not take at tensor > 1: ROADMAP C12)
    ("fsdp2-tensor2-512-flash", 64, PARITY_BATCH_512, F2T2, torch.float32, None, None, True),
    ("fsdp2-tensor2-nu", 32, PARITY_BATCH, F2T2, torch.float32, "bfloat16", None, None),
    ("fsdp2-tensor2-bf16-nu", 32, PARITY_BATCH, F2T2, torch.bfloat16, "bfloat16", None, None),
]
MESH_SAME_AS = {"fsdp2-tensor2-full": "fsdp2-tensor2", "data2-fsdp2-names_lite": "data2-fsdp2",
                "fsdp2-tensor2-512-dots": "fsdp2-tensor2-512"}
MESH_TRAIN, MESH_TRAIN_STEPS, MESH_TRAIN_BATCH = "data=1,fsdp=2,tensor=2", 4, 16
# the staged update (train.fused_adam: false; plain PyTorch, kernel #7 never
# launched): [train-staged] TRAIN_CONFIG with the override for
# TRAIN_STEPS_STAGED steps; [train-staged-nu] with bf16 mu and nu (the SR
# twin) for TRAIN_STEPS_STAGED_NU; [parity-train-staged] one fp32 step of
# the parity model, staged vs the fused kernel's step and vs the staged
# update on a CPU copy of the same tensors
TRAIN_STEPS_STAGED, TRAIN_STEPS_STAGED_NU = 6, 4
STAGED_CPU_ELEMENTS = 1 << 24  # 16.8M of the 730M: the layout's first parameters
STAGED_OVERRIDES = ("train.fused_adam=false",)
STAGED_NU_OVERRIDES = STAGED_OVERRIDES + ("train.nu_dtype=bfloat16",
                                          "train.moment_dtype=bfloat16")
# [aot]: sample256's sampler (DiT-XL/2 at full depth and width, bf16, CFG
# 1.5, batch SEEDS) exported by sampling/aot.py and reloaded in a fresh
# process that imports only torch and maskdit_tpu_torch.ops; the export
# unrolls every evaluation (3 x 36 blocks at AOT_STEPS), so it is cut from
# 40 steps to AOT_STEPS for the script's time. Then the 512-px sampler (#3)
# and the use_flash one (#5), FLASH_DEPTH encoder blocks, at AOT_STEPS too
# (one Heun step is not a schedule: 1 / (num_steps - 1)). Held to the live
# sampler within MODEL_REL_BOUND. [aot] is exported through the generate
# CLI with S_churn AOT_CHURN: the reloading process draws the churn noise
# with LoadedSampler.churn_noise from a CUDA generator seeded as the live
# sampler's
AOT_STEPS = 2
AOT_CHURN, AOT_CHURN_SEED = 1, 7  # the CLI takes --S_churn as an int, as the JAX CLI does
AOT_CKPT = os.path.join(SCRATCH, "random-xl2-aot.pt")  # [weights]' first FLASH_DEPTH blocks
# the tool and script twins. [validate-port]: a reference-layout file of
# [weights]' tensors as ``ema`` and the same plus VALIDATE_DELTA as
# ``model``; the sigma table's evaluations (one unmasked forward each, no
# CFG) and the sample's (CFG, 40 steps) in whole-row (256 px) or blocked
# (512 px) launches
VALIDATE_CKPT = os.path.join(SCRATCH, "random-xl2-validate.pt")
VALIDATE_DELTA = 1e-3
VALIDATE_SIGMAS, VALIDATE_SAMPLES = 5, 8
# [mu-curve]: the twin's default run (DiT-S/2: 12 encoder + 8 decoder
# blocks, all on the whole-row kernels at its 32 kept and 64 tokens); the
# divergence guard: the last 20 steps' mean losses within this share of the
# fp32 run's (a guard against divergence, not a parity bound)
MU_CURVE_STEPS, MU_CURVE_BLOCKS, MU_CURVE_GUARD = 200, 12 + 8, 0.05
# [trace]: the capture twin's train mode at [train-profile]'s batch (its
# 1 + 2 + 5 untraced and N_STEPS traced steps), its sample mode at
# TRACE_SAMPLE_STEPS steps, batch SEEDS (3 sampler runs: first, steady,
# traced); the train report's device ms per step against [train-profile]'s
# busy ms
TRACE_STEPS, TRACE_SAMPLE_STEPS, TRACE_BUSY_TOLERANCE = 3, 4, 0.10
# [attn-bench]: the twin's calls per row (one warm-up + 30 timed, forward;
# the same, forward + backward). A kernel may refuse only a row the JAX
# package's window sends elsewhere (flash_batched.jax_window)
ATTN_BENCH_CALLS = 31


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


def tensor_core_bound_note(n: int, l: int, h: int, hd: int, dtype: torch.dtype, products: int,
                           ms: float) -> str:
    """For an fp32 row: the tensor cores' bound of FP32_TERMS bf16 products
    per fp32 product (the operations bound of the fp32 tensor-core kernels'
    scheme) and the kernel's share of it; '' for bf16."""
    if dtype != torch.float32:
        return ""
    tc_ms = FP32_TERMS * 2 * products * n * h * l * l * hd / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (f"; fp32 FMA bound above, tensor-core bound of {FP32_TERMS} bf16 products per "
            f"fp32 product {tc_ms:.4f} ms, {tc_ms / ms:.3f} of it")


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


# the kernels' numbers in the table of PERF.md, by counter
KERNEL_NUMBERS = {"packed_fwd": "#1", "packed_bwd": "#2", "big_fwd": "#3", "big_bwd": "#4",
                  "flash_fwd": "#5", "flash_bwd": "#6", "adam": "#7"}


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
    """One nvcc for each kernel source, all started at once; every build
    ends before the first timed row, so that no row is timed while nvcc
    (``-split-compile=0`` takes every core) holds the host's cores."""
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
        for es in (2, 4):
            assert fl.flash_fwd_smem_bytes(hd, es) == flash.fwd_smem_bytes(hd, es), (hd, es)
            assert fl_bwd.flash_bwd_smem_bytes(hd, es) == flash.bwd_smem_bytes(hd, es), (hd, es)
    for hd in SWEEP_HEAD_DIMS:  # the tensor-core forward's and backward's, per head dim
        assert big.packed_attention_big_fwd_smem_bytes(2048, hd, 2) == \
            fl.flash_fwd_smem_bytes(hd, 2) == flash_big.mma_fwd_smem_bytes(hd), hd
        assert bwd.packed_attention_bwd_smem_bytes(2048, hd, 2) == \
            big_bwd.packed_attention_big_bwd_smem_bytes(2048, hd, 2) == \
            flash_batched.mma_bwd_smem_bytes(hd), hd
        assert fl_bwd.flash_bwd_smem_bytes(hd, 2) == flash.bwd_smem_bytes(hd, 2), hd
        # the fp32 tensor-core kernels (#1 / #3 / #5 forward, #2 / #4 / #6
        # backward: one header, the same tiles in both layouts at every L)
        assert fl.flash_fwd_smem_bytes(hd, 4) == flash_batched.fp32_fwd_smem_bytes(hd), hd
        assert fl_bwd.flash_bwd_smem_bytes(hd, 4) == flash_batched.fp32_bwd_smem_bytes(hd), hd
        for l in (77, 224, 2048):
            assert fwd.packed_attention_fwd_smem_bytes(l, hd, 4) == \
                big.packed_attention_big_fwd_smem_bytes(l, hd, 4) == \
                flash_batched.fwd_smem_bytes(l, hd, 4) == \
                flash_batched.fp32_fwd_smem_bytes(hd), (l, hd)
            assert bwd.packed_attention_bwd_smem_bytes(l, hd, 4) == \
                big_bwd.packed_attention_big_bwd_smem_bytes(l, hd, 4) == \
                flash_batched.bwd_smem_bytes(l, hd, 4) == \
                flash_batched.fp32_bwd_smem_bytes(hd), (l, hd)
        # the bf16 whole-row forward (#1): the tensor-core kernel at every L
        # of the route's old window up to 832 and at the JAX window's 768,
        # and its layout where it runs
        for l in (77, 128, 256, 384, 600, 768, 832):
            assert fwd.packed_attention_fwd_smem_bytes(l, hd, 2) == \
                flash_batched.fwd_smem_bytes(l, hd, 2), (l, hd)
            if flash_batched.route_window(l, hd, False) or flash_batched.supports(2, l, hd):
                assert flash_batched.fwd_kernel(torch.bfloat16, l, hd) == "mma", (l, hd)
                assert fwd.packed_attention_fwd_smem_bytes(l, hd, 2) == \
                    flash_batched.mma_fwd_smem_bytes(l, hd), (l, hd)
    log("[kernel] the routing rule's shared-memory formulas equal the libraries' at 11 shapes "
        "in bf16 and fp32, the tensor-core kernels' (the blocked and flash forwards, both "
        "packed backwards and the flash backward in bf16 and fp32, the fp32 forwards, the "
        "whole-row forward at 7 L) at 16 head dims")


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


def blocked_variant(dtype: torch.dtype, *shape: int) -> str:
    """The kernels the blocked wrappers (#3, #4) launch at every shape:
    'mma' (bf16 operands on mma.sync) or 'mma6' (fp32: each product as six
    bf16 mma.sync products of exact bf16 pieces)."""
    return "mma" if dtype == torch.bfloat16 else "mma6"


def check_variant(what: str, dtype: torch.dtype, hd: int, variant: str,
                  fp32: bool = False) -> None:
    """A bf16 call at a head dim that is a multiple of 8 runs the
    tensor-core kernels ('mma'), never the FMA ones; with ``fp32`` (the
    whole-row and the blocked kernels) so does an fp32 call ('mma6')."""
    want = {torch.bfloat16: "mma", torch.float32: "mma6" if fp32 else variant}[dtype]
    if hd % 8 == 0 and variant != want:
        raise AssertionError(f"{what}: {dtype_name(dtype)} at hd {hd} ran the {variant} "
                             f"kernel, not {want}")


def attention_fwd_rows(tag: str, shapes, kernel, plain, seed: int, iters: int,
                       variant=None, dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """The forward wrapper ``kernel`` against ``plain`` at each shape and
    type of ``dtypes``: error, kernel, plain and library times, bound.
    ``variant(dtype, L, hd)``, where given, names the kernel that ran (mma,
    mma6 or fma)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, n, l, h, hd in shapes:
        for dtype in dtypes:
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
                check_variant(f"{tag} {name}", dtype, hd, variant(dtype, l, hd), fp32=True)
            log(f"[{tag}] {name} N={n} L={l} H={h} hd={hd} {dt}{ran}: max_abs_err {err:.3e} "
                f"(bound {bnd:.3e} = {FWD_REL_BOUND[dtype]:.0e} x max|ref|), elements "
                f"differing {share:.5f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"library (SDPA) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), {bound_ms / ms:.3f} of it"
                + tensor_core_bound_note(n, l, h, hd, dtype, 2, ms))
            if not (ok and launches == 1):
                raise AssertionError(f"{tag} {name} {dt}: err {err} > {bnd}, share {share} "
                                     f"or {launches} launches")
            results[(name, dt)] = dict(err=err, share=share, ms=ms, plain_ms=plain_ms,
                                       library_ms=library_ms, bound_ms=bound_ms,
                                       bound_by=bound_by)
            del qkv
    free_device_memory()
    return results


def attention_bwd_rows(tag: str, shapes, kernel, plain, seed: int, iters: int,
                       dtypes=(torch.bfloat16, torch.float32), variant=None) -> dict:
    """The backward wrapper ``kernel`` against ``plain``, as above; the
    library time is SDPA's forward and backward. Each row names the kernels
    that ran: ``variant(dtype, hd)``, by default the whole-row backward's
    ('mma', bf16, csrc/attention_bwd_mma.cuh; 'mma6', fp32,
    csrc/attention_fp32_mma.cuh; or 'fma')."""
    from maskdit_tpu_torch.ops.flash_batched import bwd_kernel

    variant = variant or bwd_kernel

    g = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    for name, n, l, h, hd in shapes:
        for dtype in dtypes:
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
            check_variant(f"{tag} bwd {name}", dtype, hd, variant(dtype, hd), fp32=True)
            log(f"[{tag}] attention bwd {name} N={n} L={l} H={h} hd={hd} {dt} "
                f"({variant(dtype, hd)}): "
                f"max_abs_err {err:.3e} (bound {bnd:.3e} = {BWD_REL_BOUND[dtype]:.0e} "
                f"x max|ref|), elements differing {share:.5f}; kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library (SDPA fwd + bwd) {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it"
                + tensor_core_bound_note(n, l, h, hd, dtype, 6, ms)
                + f"; launches per call {launches}")
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
    rows = attention_fwd_rows("kernel", ATTN_FWD_SHAPES, flash_batched.packed_attention,
                              flash_batched.packed_attention_reference, seed=0, iters=50,
                              variant=flash_batched.fwd_kernel)
    rows.update(attention_fwd_rows("kernel", CLS_FWD_SHAPES, flash_batched.packed_attention,
                                   flash_batched.packed_attention_reference, seed=2, iters=50,
                                   variant=flash_batched.fwd_kernel, dtypes=(torch.bfloat16,)))
    rows.update(attention_fwd_rows("kernel", MESH_ATTN_SHAPES, flash_batched.packed_attention,
                                   flash_batched.packed_attention_reference, seed=4, iters=50,
                                   variant=flash_batched.fwd_kernel, dtypes=(torch.bfloat16,)))
    return rows


def phase_bwd_kernels() -> dict:
    from maskdit_tpu_torch.ops import flash_batched

    rows = attention_bwd_rows("kernel", BWD_SHAPES, flash_batched.packed_attention_bwd,
                              flash_batched.packed_attention_bwd_reference, seed=1, iters=20)
    rows.update(attention_bwd_rows("kernel", CLS_BWD_SHAPES, flash_batched.packed_attention_bwd,
                                   flash_batched.packed_attention_bwd_reference, seed=3, iters=20,
                                   dtypes=(torch.bfloat16,)))
    rows.update(attention_bwd_rows("kernel", MESH_ATTN_SHAPES, flash_batched.packed_attention_bwd,
                                   flash_batched.packed_attention_bwd_reference, seed=5, iters=20,
                                   dtypes=(torch.bfloat16,)))
    return rows


def check_unmasked_256_route() -> None:
    """One XL/2 attention layer at the unmasked 256-px shape (batch 2, L 256,
    hd 72) on the card: with a backward and without one it launches the
    whole-row kernels, as the JAX package does, and no plain attention
    runs."""
    from maskdit_tpu_torch.models.layers import Attention

    attn = Attention(16 * 72, 16, dtype=torch.bfloat16).cuda()
    x = torch.randn(2, 256, 16 * 72, device="cuda", requires_grad=True)
    reset_launches()
    attn(x).float().square().sum().backward()
    torch.cuda.synchronize()
    expect_launches("kernel-big", read_launches(), packed_fwd=1, packed_bwd=1)
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
                             flash_big.packed_attention_big_reference, seed=5, iters=10,
                             variant=blocked_variant)
    bwd = attention_bwd_rows("kernel-big", BIG_BWD_SHAPES, flash_big.packed_attention_big_bwd,
                             flash_big.packed_attention_big_bwd_reference, seed=6, iters=5,
                             variant=blocked_variant)
    fwd.update(attention_fwd_rows("kernel-big", CLS_BIG_SHAPES, flash_big.packed_attention_big,
                                  flash_big.packed_attention_big_reference, seed=7, iters=10,
                                  variant=blocked_variant, dtypes=(torch.bfloat16,)))
    bwd.update(attention_bwd_rows("kernel-big", CLS_BIG_SHAPES,
                                  flash_big.packed_attention_big_bwd,
                                  flash_big.packed_attention_big_bwd_reference, seed=8, iters=5,
                                  variant=blocked_variant, dtypes=(torch.bfloat16,)))
    return dict(fwd=fwd, bwd=bwd)


def check_fp32_head_dims(what: str, fwd, fwd_plain, bwd, bwd_plain, shape, seed: int) -> float:
    """fp32 attention kernels (on the tensor cores in bf16 pieces,
    csrc/attention_fp32_mma.cuh) at every head dim of SWEEP_HEAD_DIMS, at
    (N, L, H) = ``shape``: one launch each way, within FWD_REL_BOUND /
    BWD_REL_BOUND of the plain versions, timed. Returns the worst error."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    fp32 = torch.float32
    n, l, h = shape
    worst_err, worst, rows = 0.0, 0.0, []
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda")
        dout = torch.randn(n, l, h * hd, generator=g, device="cuda")
        before = (fwd.launches, bwd.launches)
        with torch.no_grad():
            out = fwd(qkv, h, scale)
        dqkv = bwd(qkv, dout, h, scale)
        torch.cuda.synchronize()
        launches = (fwd.launches - before[0], bwd.launches - before[1])
        with torch.no_grad():
            f = compare(out, fwd_plain(qkv, h, scale), FWD_REL_BOUND[fp32], fp32)
        b = compare(dqkv, bwd_plain(qkv, dout, h, scale), BWD_REL_BOUND[fp32], fp32)
        if not (f[3] and b[3] and launches == (1, 1)):
            raise AssertionError(f"{what} fp32 hd sweep hd={hd}: fwd err {f[0]} > {f[1]} or "
                                 f"bwd err {b[0]} > {b[1]} or launches {launches}")
        with torch.no_grad():
            ms = cuda_ms(lambda: fwd(qkv, h, scale), 5)
        bms = cuda_ms(lambda: bwd(qkv, dout, h, scale), 5)
        worst_err = max(worst_err, f[0], b[0])
        worst = max(worst, f[0] / f[1], b[0] / b[1])
        rows.append(f"{hd}: {ms:.4f} / {bms:.4f}")
    log(f"[kernel-fp32] head dims: {what} fp32 (mma6) at (N, L, H) = {shape}, hd "
        f"{SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step {SWEEP_HEAD_DIMS.step}: "
        f"{2 * len(SWEEP_HEAD_DIMS)} rows within their bounds; the worst error {worst:.3f} of "
        f"its bound ({worst_err:.3e}); fwd / bwd ms by hd " + ", ".join(rows))
    free_device_memory()
    return worst_err


def phase_fp32_kernels() -> dict:
    """[kernel-fp32]: the finetune paths' attention in fp32 (the released
    finetunes train with ``train.fp32: True``) at FINETUNE_ATTN_SHAPES, on
    the kernels ``attention_route`` picks there with a backward (whole-row
    #1/#2 or blocked #3/#4, both on the tensor cores: 'mma6'), forward and
    backward against their plain versions, with SDPA's times and the bounds;
    then #3/#4 in fp32 at the ragged shape, and both pairs over the head
    dims."""
    from maskdit_tpu_torch.models.layers import attention_route
    from maskdit_tpu_torch.ops import flash_batched, flash_big

    kernels = {
        "packed": (flash_batched.packed_attention, flash_batched.packed_attention_reference,
                   flash_batched.packed_attention_bwd,
                   flash_batched.packed_attention_bwd_reference, flash_batched.fwd_kernel,
                   flash_batched.bwd_kernel),
        "big": (flash_big.packed_attention_big, flash_big.packed_attention_big_reference,
                flash_big.packed_attention_big_bwd, flash_big.packed_attention_big_bwd_reference,
                blocked_variant, blocked_variant),
    }
    fp32 = (torch.float32,)
    out = {}
    for i, shape in enumerate(FINETUNE_ATTN_SHAPES + [RAGGED_BIG]):
        name, n, l, h, hd = shape
        route = attention_route(h, l, hd, True) if shape != RAGGED_BIG else "big"
        log(f"[kernel-fp32] {name} (N={n}, L={l}, H={h}, hd={hd}): "
            + (f"route '{route}' with a backward" if shape != RAGGED_BIG else "#3 / #4"))
        fwd, fwd_plain, bwd, bwd_plain, fwd_variant, bwd_variant = kernels[route]
        rows = attention_fwd_rows("kernel-fp32", [shape], fwd, fwd_plain, seed=20 + i, iters=5,
                                  variant=fwd_variant, dtypes=fp32)
        rows.update({(k[0], "bwd"): v for k, v in attention_bwd_rows(
            "kernel-fp32", [shape], bwd, bwd_plain, seed=30 + i, iters=3, dtypes=fp32,
            variant=bwd_variant).items()})
        out[name] = dict(route=route, fwd=rows[(name, "float32")], bwd=rows[(name, "bwd")])
    big_err = check_fp32_head_dims("#3 / #4", flash_big.packed_attention_big,
                                   flash_big.packed_attention_big_reference,
                                   flash_big.packed_attention_big_bwd,
                                   flash_big.packed_attention_big_bwd_reference, SWEEP_SHAPE, 41)
    packed_err = check_fp32_head_dims("#1 / #2", flash_batched.packed_attention,
                                      flash_batched.packed_attention_reference,
                                      flash_batched.packed_attention_bwd,
                                      flash_batched.packed_attention_bwd_reference,
                                      PACKED_SWEEP_SHAPE, 43)
    # the class token's lengths in fp32: the kernels the route takes there,
    # #1 (#2 with a backward) at L 257 / 129 and #3 / #4 at L 257
    routes = (attention_route(16, 257, 72, False), attention_route(16, 257, 72, True),
              attention_route(16, 129, 72, True))
    log(f"[kernel-fp32] class-token lengths: routes (16, 257, 72) fwd '{routes[0]}', with a "
        f"backward '{routes[1]}'; (16, 129, 72) with a backward '{routes[2]}'")
    if routes != ("packed", "big", "packed"):
        raise AssertionError(f"kernel-fp32: class-token routes {routes}")
    packed, big = kernels["packed"], kernels["big"]
    cls = dict(
        packed_fwd=attention_fwd_rows("kernel-fp32", CLS_FWD_SHAPES, *packed[:2], seed=50, iters=5,
                                      variant=packed[4], dtypes=fp32),
        packed_bwd=attention_bwd_rows("kernel-fp32", CLS_BWD_SHAPES, *packed[2:4], seed=51,
                                      iters=3, dtypes=fp32, variant=packed[5]),
        big_fwd=attention_fwd_rows("kernel-fp32", CLS_BIG_SHAPES, *big[:2], seed=52, iters=5,
                                   variant=big[4], dtypes=fp32),
        big_bwd=attention_bwd_rows("kernel-fp32", CLS_BIG_SHAPES, *big[2:4], seed=53, iters=3,
                                   dtypes=fp32, variant=big[5]),
    )
    return dict(rows=out, sweep_err=big_err, packed_sweep_err=packed_err, cls=cls)


def flash_fwd_row(name: str, n: int, l: int, h: int, hd: int, dtype: torch.dtype,
                  g: torch.Generator, iters: int, variant: str | None = None) -> dict:
    """The flash forward kernel against its plain version at one shape.
    ``variant`` names the kernel that ran; by default ``flash.fwd_kernel``'s,
    which must be on the tensor cores (mma, or mma6 in fp32)."""
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
    ran = variant or flash.fwd_kernel(dtype)
    check_variant(f"flash fwd {name}", dtype, hd, ran, fp32=variant is None)
    log(f"[kernel-flash] fwd {name} N={n} L={l} H={h} hd={hd} {dt} ({ran}): max_abs_err "
        f"{err:.3e} (bound {bnd:.3e} = {FWD_REL_BOUND[dtype]:.0e} x max|ref|), elements "
        f"differing {share:.5f}, lse err {lse_err:.3e} (bound {lse_bnd:.3e}); kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, library (SDPA) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it"
        + tensor_core_bound_note(n, l, h, hd, dtype, 2, ms))
    if not (ok and lse_err <= lse_bnd and launches == 1):
        raise AssertionError(f"flash fwd {name} {dt}: err {err} > {bnd}, share {share}, lse "
                             f"{lse_err} > {lse_bnd} or {launches} launches")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flash_bwd_row(name: str, n: int, l: int, h: int, hd: int, dtype: torch.dtype,
                  g: torch.Generator, iters: int, variant: str | None = None) -> dict:
    """The flash backward kernel against its plain version at one shape, on
    the forward kernel's residuals; the library time is SDPA's forward and
    backward. ``variant`` as for flash_fwd_row (``flash.bwd_kernel``)."""
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
    ran = variant or flash.bwd_kernel(dtype)
    check_variant(f"flash bwd {name}", dtype, hd, ran, fp32=variant is None)
    log(f"[kernel-flash] bwd {name} N={n} L={l} H={h} hd={hd} {dt} ({ran}): "
        f"dq/dk/dv max_abs_err "
        f"{'/'.join(f'{c[0]:.3e}' for c in checks)} (bounds "
        f"{'/'.join(f'{c[1]:.3e}' for c in checks)} = {BWD_REL_BOUND[dtype]:.0e} x max|ref|), "
        f"elements differing {'/'.join(f'{c[2]:.5f}' for c in checks)}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (SDPA fwd + bwd) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it"
        + tensor_core_bound_note(n, l, h, hd, dtype, 5, ms))
    if not (ok and launches == 1):
        raise AssertionError(f"flash bwd {name} {dt}: checks {checks} or {launches} launches")
    return dict(err=err, share=share, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def flash_pair_errors(q, k, v, do, scale: float, dtype: torch.dtype) -> tuple:
    """Both flash kernels on q, k, v, do (one launch each) against their
    plain versions: o, dq, dk, dv within FWD_REL_BOUND / BWD_REL_BOUND (and
    BF16_MISMATCH_BOUND) and lse within LSE_REL_BOUND of max|lse|. Returns
    the worst error as a share of its bound, the largest share of differing
    elements and the worst absolute errors of the forward (o) and of the
    backward (dq, dk, dv)."""
    from maskdit_tpu_torch.ops import flash

    before = flash.flash_fwd.launches, flash.flash_bwd.launches
    o, lse = flash.flash_fwd(q, k, v, scale)
    grads = flash.flash_bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    launches = flash.flash_fwd.launches - before[0], flash.flash_bwd.launches - before[1]
    ref_o, ref_lse = flash.flash_fwd_reference(q, k, v, scale)
    ref_grads = flash.flash_bwd_reference(q, k, v, o, lse, do, scale)
    worst, worst_share, abs_err = 0.0, 0.0, []
    pairs = [(o, ref_o, FWD_REL_BOUND[dtype])] + [
        (a, b, BWD_REL_BOUND[dtype]) for a, b in zip(grads, ref_grads)]
    for got, ref, rel in pairs:
        err, bnd, share, ok = compare(got, ref, rel, dtype)
        if not ok:
            raise AssertionError(f"err {err} > {bnd} or share {share}")
        worst, worst_share = max(worst, err / bnd), max(worst_share, share)
        abs_err.append(err)
    lse_err = (lse - ref_lse).abs().max().item() / ref_lse.abs().max().item()
    if lse_err > LSE_REL_BOUND or launches != (1, 1):
        raise AssertionError(f"lse rel err {lse_err}, launches {launches}")
    return worst, worst_share, abs_err[0], max(abs_err[1:])


def check_flash_window() -> dict:
    """Both flash kernels launch and agree with their plain versions (o,
    lse, dq, dk, dv) at every L of their window, 128 to 2048 in steps of
    128, at the model head dims 32, 64 and 72, in bf16 and fp32 (N*H = 2).
    Returns the worst fp32 absolute errors, forward and backward."""
    from maskdit_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(8)
    fp32_abs = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst, worst_share, shapes = 0.0, 0.0, 0
        for hd in (32, 64, 72):
            for l in range(flash.LANE, flash.MAX_L + 1, flash.LANE):
                q, k, v, do = (torch.randn(2, l, hd, generator=g, device="cuda").to(dtype)
                               for _ in range(4))
                try:
                    err, share, *abs_err = flash_pair_errors(q, k, v, do, hd ** -0.5, dtype)
                except AssertionError as e:
                    raise AssertionError(f"flash window L={l} hd={hd} {dtype_name(dtype)}: "
                                         f"{e}") from None
                worst, worst_share = max(worst, err), max(worst_share, share)
                if dtype == torch.float32:
                    fp32_abs = {d: max(fp32_abs[d], e) for d, e in zip(("fwd", "bwd"), abs_err)}
                shapes += 1
        log(f"[kernel-flash] window: fwd and bwd at every L of 128-2048 (step 128) x hd 32, "
            f"64, 72, {dtype_name(dtype)} ({flash.fwd_kernel(dtype)} / "
            f"{flash.bwd_kernel(dtype)}), N*H 2: {shapes} shapes within their bounds; the "
            f"worst error {worst:.3f} of its bound, the largest share of differing elements "
            f"{worst_share:.5f}")
    return fp32_abs


def check_flash_fp32_head_dims() -> dict:
    """The fp32 flash kernels (#5, #6: csrc/attention_fp32_mma.cuh in the
    separate-heads layout, 'mma6') launch once per call and agree with their
    plain versions (o, lse, dq, dk, dv) at every head dim of
    SWEEP_HEAD_DIMS, at SWEEP_SHAPE; timed. Returns the worst absolute
    errors, forward and backward."""
    from maskdit_tpu_torch.ops import flash

    g = torch.Generator(device="cuda").manual_seed(13)
    fp32 = torch.float32
    n, l, h = SWEEP_SHAPE
    check_variant("flash fwd fp32 hd sweep", fp32, 8, flash.fwd_kernel(fp32), fp32=True)
    check_variant("flash bwd fp32 hd sweep", fp32, 8, flash.bwd_kernel(fp32), fp32=True)
    worst, worst_abs, rows = 0.0, {"fwd": 0.0, "bwd": 0.0}, []
    for hd in SWEEP_HEAD_DIMS:
        scale = hd ** -0.5
        q, k, v, do = (torch.randn(n * h, l, hd, generator=g, device="cuda") for _ in range(4))
        try:
            err, _, *abs_err = flash_pair_errors(q, k, v, do, scale, fp32)
        except AssertionError as e:
            raise AssertionError(f"flash fp32 hd sweep hd={hd}: {e}") from None
        worst = max(worst, err)
        worst_abs = {d: max(worst_abs[d], e) for d, e in zip(("fwd", "bwd"), abs_err)}
        o, lse = flash.flash_fwd(q, k, v, scale)
        ms = cuda_ms(lambda: flash.flash_fwd(q, k, v, scale), 5)
        bms = cuda_ms(lambda: flash.flash_bwd(q, k, v, o, lse, do, scale), 5)
        rows.append(f"{hd}: {ms:.4f} / {bms:.4f}")
    log(f"[kernel-flash] head dims: the fp32 flash forward and backward (#5, #6, mma6) at (N, "
        f"L, H) = {SWEEP_SHAPE}, hd {SWEEP_HEAD_DIMS.start}-{SWEEP_HEAD_DIMS.stop - 1} step "
        f"{SWEEP_HEAD_DIMS.step}: {2 * len(SWEEP_HEAD_DIMS)} rows (o, lse; dq, dk, dv) within "
        f"their bounds; the worst error {worst:.3f} of its bound (fwd {worst_abs['fwd']:.3e}, "
        f"bwd {worst_abs['bwd']:.3e}); fwd / bwd ms "
        "by hd " + ", ".join(rows))
    free_device_memory()
    return worst_abs


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
    """ops/flash.py's kernels (#5 and #6) over their window in bf16 and
    fp32, both bf16 forwards and the bf16 flash backward over the head dims
    and both fp32 flash kernels over them, then #5 and #6 at FLASH_SHAPES
    and FLASH_BWD_SHAPES, bf16 and fp32, and at FLASH_FP32_SHAPES in fp32."""
    window_err = check_flash_window()
    check_fwd_head_dims()
    check_flash_bwd_head_dims()
    sweep_err = check_flash_fp32_head_dims()
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {"fwd": {}, "bwd": {},
           "fp32_err": {d: max(window_err[d], sweep_err[d]) for d in ("fwd", "bwd")}}
    for key, shapes, row, iters in (("fwd", FLASH_SHAPES, flash_fwd_row, 10),
                                    ("bwd", FLASH_BWD_SHAPES, flash_bwd_row, 5)):
        for name, n, l, h, hd in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                out[key][(name, dtype_name(dtype))] = row(name, n, l, h, hd, dtype, g, iters)
                free_device_memory()
    for name, n, l, h, hd in FLASH_FP32_SHAPES:
        for key, row, iters in (("fwd", flash_fwd_row, 5), ("bwd", flash_bwd_row, 3)):
            out[key][(name, "float32")] = row(name, n, l, h, hd, torch.float32, g, iters)
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


def xl2_shapes() -> list:
    """(name, shape) of DiT-XL/2's parameters, in order (meta device)."""
    with torch.device("meta"):
        model = build_model(torch.bfloat16)
    return [(k, tuple(v.shape)) for k, v in model.named_parameters()]


def check_adam_shard(grads, p, m, v, e, scalars) -> dict:
    """Kernel #7 on one rank's shards of DiT-XL/2 on a {fsdp 2, tensor 2}
    mesh (the rank at fsdp 1, tensor 1: the layout of parallel/sharded.py),
    nu in bf16, with the layout's segment table: bit for bit the unsharded
    launch's p, m, v and EMA at those elements (the stochastic rounding
    draws the unsharded indices' bits) and the plain version with the same
    table; its time, the plain version's and the bytes bound."""
    from maskdit_tpu_torch.ops import fused_adam
    from maskdit_tpu_torch.parallel.sharded import ShardLayout

    shape = {"data": 1, "fsdp": 2, "tensor": 2}
    layout = ShardLayout(xl2_shapes(), shape, {"data": 0, "fsdp": 1, "tensor": 1})
    index = layout.global_index("cuda")
    full = (grads, p.clone(), m.clone(), v.to(torch.bfloat16), e.clone())
    fused_adam.launch(*full, scalars, sr_count=6)
    args = (grads[index], p[index], m[index], v.to(torch.bfloat16)[index], e[index])
    segments = layout.segments.cuda()
    got = [t.clone() for t in args[1:]]
    before = fused_adam.fused_adam_ema.launches
    fused_adam.launch(args[0], *got, scalars, sr_count=6, segments=segments)
    torch.cuda.synchronize()
    launches = fused_adam.fused_adam_ema.launches - before
    plain = fused_adam.fused_adam_ema_reference(*args, **scalars, sr_count=6, segments=segments)
    exact = all(torch.equal(a, b[index]) for a, b in zip(got, full[1:]))
    same_plain = all(torch.equal(a, b) for a, b in zip(got, plain))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, plain))
    del plain, full
    n = index.numel()
    ms = cuda_ms(lambda: fused_adam.launch(args[0], *got, scalars, sr_count=6,
                                           segments=segments), 10)
    plain_ms = cuda_ms(lambda: fused_adam.fused_adam_ema_reference(
        *args, **scalars, sr_count=6, segments=segments), 2)
    moved = n * (4 + 8 + 8 + 4 + 8) + segments.numel() * 8
    bound_ms, bound_by = bound(ADAM_OPS * n, moved, torch.float32)
    log(f"[kernel] fused adam on a shard: rank (fsdp 1, tensor 1) of a {shape} mesh of "
        f"DiT-XL/2, {n} of {p.numel()} params, {layout.segments.shape[0]} segments, nu bf16: "
        f"bit for bit with the unsharded launch at those elements {exact}, with the plain "
        f"version and the table {same_plain} (max_abs_err {err:.3e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.3f} of it; "
        f"launches {launches}")
    if not (exact and same_plain and launches == 1):
        raise AssertionError(f"fused_adam_ema on a shard: unsharded {exact}, plain "
                             f"{same_plain}, launches {launches}")
    del args, got, index, segments
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                numel=n, segments=layout.segments.shape[0])


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
    out["shard"] = check_adam_shard(grads, p, m, v, e, scalars)
    del grads, p, e, v, m
    free_device_memory()
    out["sr"] = check_stochastic_rounding()
    free_device_memory()
    return out


def build_model(dtype: torch.dtype, res: int = 32, use_flash=None, **corners):
    """The released configs' DiT-XL/2 (decoder, MAE coef 0.1, 1000 classes);
    ``corners`` are the model-corner keywords (a class token, features,
    self-conditioning)."""
    from maskdit_tpu_torch.models import create_model

    return create_model(
        "edm", img_resolution=res, img_channels=4, num_classes=1000,
        model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1, dtype=dtype,
        use_flash=use_flash, **corners,
    )


def random_weights_(model) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)


def phase_weights() -> str:
    with torch.device("cuda"):  # initialised on the card: the host's init is slower
        model = build_model(torch.bfloat16).cuda()
    random_weights_(model)
    n_params = sum(p.numel() for p in model.parameters())
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, "random-xl2.pt")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    torch.save({"ema": state}, path)
    # the finetune runs' import: model and ema the same tensors (written
    # once), without the mask token, as an unmasked run's file lacks it
    tuned = {k: v for k, v in state.items() if k != "model.mask_token"}
    torch.save({"model": tuned, "ema": tuned, "args": {}}, FINETUNE_CKPT)
    log(f"[weights] DiT-XL/2, {n_params} params ~ N(0, 0.02^2), seed 0; saved, and as a "
        f"finetune import without model.mask_token ({os.path.getsize(FINETUNE_CKPT) / 1e9:.2f} "
        f"GB), in {time.perf_counter() - t0:.1f} s")
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


def parity_model(state: dict, dtype: torch.dtype, res: int, use_flash=None, **corners):
    from maskdit_tpu_torch.utils.ckpt import load_into

    with torch.device("cuda"):  # initialised on the card: the host's init is slower
        model = build_model(dtype, res, use_flash, **corners)
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
    """One CFG denoiser evaluation at 512 px with ``use_flash=True`` (run
    under ``xl_depth(FLASH_DEPTH)``): the flash kernels (one forward launch
    per block, FLASH_DEPTH + 8, and no other attention kernel) vs their plain
    versions, in bf16 and fp32."""
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    # the checkpoint's first FLASH_DEPTH encoder blocks: the model is built
    # at that depth (xl_depth)
    dropped = tuple(f"model.blocks.{i}." for i in range(FLASH_DEPTH, DEPTH))
    state = {k: v for k, v in load_reference_checkpoint(ckpt).items() if not k.startswith(dropped)}
    x, sigma, y = denoiser_inputs(SEEDS_512, 64)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = parity_model(state, dtype, 64, use_flash=True)
        out[dtype_name(dtype)] = check_denoiser("parity-flash", model, x, sigma, y,
                                                flash_fwd=FLASH_ATTN_PER_STEP)
        del model
    free_device_memory()
    return out


def phase_aot(ckpt: str) -> dict:
    """sample256's sampler exported at AOT_STEPS with S_churn AOT_CHURN
    through the generate CLI (``--export_aot``, from AOT_CKPT: [weights]'
    first FLASH_DEPTH encoder blocks as a reference .pt), DiT-XL/2 at
    FLASH_DEPTH encoder blocks, full width, bf16, CFG 1.5, batch SEEDS; then
    the 512-px one (#3) and the use_flash one (#5) at FLASH_DEPTH encoder
    blocks too (``sampling/aot.export_sampler``). Each checks the export
    path, not the model's depth (the 256-px one ran at full depth before the
    tool twins came).
    Every file is exported and every live sampler timed first; then one
    fresh process that imports only torch and maskdit_tpu_torch.ops
    (``worker_aot_reload``) reloads each file with ``load_sampler`` and
    samples with the same weights, latents and labels as the live sampler
    (the churn noise drawn by ``LoadedSampler.churn_noise`` from a CUDA
    generator seeded as the live sampler's). Each is held to the live output
    within MODEL_REL_BOUND[bf16] and to its launches (one per attention
    layer and evaluation, counted by the op's own counter in that process),
    with export seconds, file MB, reload seconds and warm images/s beside
    the live sampler's."""
    from maskdit_tpu_torch import generate
    from maskdit_tpu_torch.sampling.aot import export_sampler
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, make_sample_fn
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    evals = 2 * AOT_STEPS - 1
    state = load_reference_checkpoint(ckpt)
    dropped = tuple(f"model.blocks.{i}." for i in range(FLASH_DEPTH, DEPTH))
    shallow = {k: v for k, v in state.items() if not k.startswith(dropped)}
    torch.save({"ema": shallow}, AOT_CKPT)
    # tag: (resolution, use_flash, depth context, weights, S_churn, counter,
    # launches per run)
    plans = {
        "aot": (32, None, xl_depth(FLASH_DEPTH), shallow, AOT_CHURN, "packed_fwd",
                evals * FLASH_ATTN_PER_STEP),
        "aot-512": (64, None, xl_depth(FLASH_DEPTH), shallow, 0.0, "big_fwd",
                    evals * FLASH_ATTN_PER_STEP),
        "aot-flash": (32, True, xl_depth(FLASH_DEPTH), shallow, 0.0, "flash_fwd",
                      evals * FLASH_ATTN_PER_STEP),
    }
    jobs, out = [], {}
    for tag, (res, use_flash, depth, weights, churn, counter, launches) in plans.items():
        free_device_memory()
        cfg = SamplerConfig(num_steps=AOT_STEPS, cfg_scale=CFG, S_churn=churn)
        path = os.path.join(SCRATCH, f"{tag}.pt2")
        with depth:
            model = parity_model(weights, torch.bfloat16, res, use_flash=use_flash)
            if tag == "aot":  # as a user exports: the CLI builds its own model
                export_s = generate.main([
                    "--ckpt_path", AOT_CKPT, "--export_aot", path, "--max_batch_size", str(SEEDS),
                    "--cfg_scale", str(CFG), "--num_steps", str(AOT_STEPS),
                    "--S_churn", str(churn), "--model_type", "DiT-XL/2", "--image_size",
                    str(res), "--image_channels", "4", "--num_classes", "1000",
                    "--use_decoder", "True", "--mae_loss_coef", "0.1"])["seconds"]
            else:
                t0 = time.perf_counter()
                export_sampler(model, cfg, SEEDS, path)
                export_s = time.perf_counter() - t0
            x, _, y = denoiser_inputs(SEEDS, res)
            seed = AOT_CHURN_SEED if churn else None
            generator = lambda: (torch.Generator("cuda").manual_seed(seed)
                                 if seed is not None else None)
            sample = make_sample_fn(model, cfg)
            live = sample(x, y, generator())
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sample(x, y, generator())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        inputs = os.path.join(SCRATCH, f"{tag}-inputs.pt")
        torch.save((x.cpu(), y.cpu()), inputs)
        jobs.append(dict(tag=tag, path=path, inputs=inputs, counter=counter, launches=launches,
                         churn_seed=seed, out=os.path.join(SCRATCH, f"{tag}-out.pt")))
        out[tag] = dict(live=live.cpu(), export_s=export_s, mb=os.path.getsize(path) / 1e6,
                        live_images_per_s=[SEEDS / t for t in times], res=res, churn=churn)
        del model, sample, live
    del state, shallow, weights
    free_device_memory()
    jobs_path, result = (os.path.join(SCRATCH, f"aot-{name}.json") for name in ("jobs", "result"))
    with open(jobs_path, "w") as f:
        json.dump(dict(jobs=jobs, weights=AOT_CKPT), f)
    t_reload = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", "aot-reload", jobs_path, result],
        capture_output=True, text=True, cwd=ROOT, timeout=WORKER_TIMEOUT)
    for line in proc.stdout.splitlines():
        log(f"[aot:out] {line}")
    if proc.returncode != 0:
        raise AssertionError(f"aot: the reloading process failed ({proc.returncode}):\n"
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(result) as f:
        reloaded = json.load(f)
    log(f"[aot] the reloading process ran {time.perf_counter() - t_reload:.1f} s, alone; its "
        f"modules of the port: {reloaded['modules']}")
    bad = [m for m in reloaded["modules"]
           if m.startswith(("maskdit_tpu_torch.models", "maskdit_tpu_torch.sampling", "jax",
                            "maskdit_tpu."))]
    if bad:
        raise AssertionError(f"aot: the reloading process imported {bad}")
    total = {name: 0 for name in kernel_counters()}
    bnd = MODEL_REL_BOUND[torch.bfloat16]
    for job in jobs:
        tag, got = job["tag"], reloaded["jobs"][job["tag"]]
        expect_launches(tag, got["launches"], **{job["counter"]: job["launches"]})
        for name, count in got["launches"].items():
            total[name] += count
        live, exported = out[tag].pop("live"), torch.load(job["out"])
        rel = ((exported.float() - live.float()).abs().max() / live.float().abs().max()).item()
        exact = torch.equal(exported, live)
        r = out[tag]
        depth = f"{FLASH_DEPTH} encoder blocks"
        how = "the generate CLI" if tag == "aot" else "export_sampler"
        log(f"[{tag}] DiT-XL/2 @{r['res'] * 8} ({depth}), bf16, CFG {CFG}, S_churn {r['churn']}, "
            f"batch {SEEDS}, {AOT_STEPS} steps ({evals} evaluations): export through {how} "
            f"{r['export_s']:.1f} s, file {r['mb']:.1f} MB, reload {got['reload_s']:.1f} s; "
            f"exported vs live max rel err {rel:.3e} (bound {bnd:.0e}), bit for bit {exact}, "
            f"finite {bool(torch.isfinite(exported).all())}; warm images/s exported "
            f"{[round(v, 3) for v in got['images_per_s']]}, live "
            f"{[round(v, 3) for v in r['live_images_per_s']]}")
        if not (torch.isfinite(exported).all() and rel <= bnd):
            raise AssertionError(f"{tag}: exported vs live {rel}")
        r.update(rel=rel, exact=exact, **got)
    out["launches"] = total
    return out


def worker_aot_reload(jobs_path: str, result: str) -> None:
    """[aot]'s reloading process: imports torch and maskdit_tpu_torch.ops
    only; for each exported file in turn: ``load_sampler`` (timed), one run
    with the launch counts set to 0, two more timed, the churn noise (where
    the file takes it) from ``LoadedSampler.churn_noise`` and a CUDA
    generator seeded as the live sampler's; writes the outputs and a
    report."""
    from maskdit_tpu_torch.ops.exported import load_sampler

    with open(jobs_path) as f:
        spec = json.load(f)
    weights = torch.load(spec["weights"])["ema"]  # a reference-layout file (AOT_CKPT)
    report = {}
    for job in spec["jobs"]:
        t0 = time.perf_counter()
        sample = load_sampler(job["path"])
        reload_s = time.perf_counter() - t0
        device = torch.device(sample.meta["device"])  # the program's, where it was exported
        params = {k: weights[k].to(device) for k in sample.meta["param_names"]}
        x, y = (t.to(device) for t in torch.load(job["inputs"]))
        seed = job["churn_seed"]
        noise = lambda: (sample.churn_noise(torch.Generator(device).manual_seed(seed))
                         if seed is not None else None)
        reset_launches()
        z = sample(params, x, y, noise())
        torch.cuda.synchronize()
        launches = read_launches()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            sample(params, x, y, noise())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        torch.save(z.cpu(), job["out"])
        report[job["tag"]] = dict(reload_s=reload_s, launches=launches,
                                  images_per_s=[x.shape[0] / t for t in times])
        del params, sample
    with open(result, "w") as f:
        json.dump(dict(jobs=report, modules=sorted(
            m for m in sys.modules if m.startswith(("maskdit", "jax")))), f)


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


def profile_device(tag: str, fn, reps: int, what: str) -> tuple[float, float]:
    """Wall time of ``fn`` unprofiled, then device time by kernel name
    from torch.profiler, per call, over ``reps`` calls; returns the wall and
    the device busy ms per call."""
    from torch.profiler import ProfilerActivity, profile

    from maskdit_tpu_torch.ops.build import RANGE_PREFIX

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
    # the device time of the kernels, memory copies and sets: the kernels'
    # launch ranges (ops/build.launch_range) span kernels counted already
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and not e.key.startswith(RANGE_PREFIX)]
    busy_ms = sum(e.self_device_time_total for e in events) / reps / 1e3
    launches = sum(e.count for e in events) // reps
    log(f"[{tag}] {what}: wall {wall_ms:.3f} ms (unprofiled), device busy {busy_ms:.3f} ms "
        f"in {launches} device ops (profiled), idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:12]:
        log(f"[{tag}]   {e.self_device_time_total / reps / 1e3:8.3f} ms  x{e.count // reps:4d}  "
            f"{e.key[:100]}")
    return wall_ms, busy_ms


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
              extra=None, write_checkpoints: bool = True, digest: bool = False,
              ratios=None) -> dict:
    """The train main path through the CLI on ``config`` with the CLI
    ``options`` and config ``overrides``, with the launch counts set to 0
    before it; checks the losses and that each step launched the kernels
    ``per_step`` names that many times, the run ``extra`` more, and no other.
    Without ``write_checkpoints`` the run's checkpoints are not written;
    with ``digest`` the result holds the final parameters' sha256. The MFU
    counts each step's mask ratio (``ratios``, per step; 0.5 by default)."""
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
    moments = [dtype_name(t.dtype) for t in (state.opt_state.mu, state.opt_state.nu)]
    del state
    config = apply_overrides(json.loads(json.dumps(config)), overrides)
    t = config["train"]
    batch, max_steps = t["batchsize"] * t.get("grad_accum", 1), t["max_num_steps"]
    every = config["log"]["log_every"]
    ratios = ratios or [0.5] * steps
    losses = [x for r in history for x in r["losses"]]
    precision = "fp32" if t.get("fp32") else "bf16"
    masks = sorted(set(ratios))
    log(f"[{tag}] {steps} steps of DiT-XL/2 @{res * 8}, batch {batch}, mask "
        f"{masks[0] if len(masks) == 1 else masks}, {precision}: "
        f"losses {[round(x, 4) for x in losses]}")
    if steps != max_steps or len(losses) != max_steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {steps} steps, losses {losses}")
    extra = extra or {}
    expect_launches(tag, launches, **{name: per_step.get(name, 0) * steps + extra.get(name, 0)
                                      for name in {*per_step, *extra}})
    warm = history[1:]  # the first window (steps 1 to log_every) is the warm-up
    seconds = sum(every / r["steps_per_sec"] for r in warm)
    warm_steps = every * len(warm)
    ips = warm_steps * batch / seconds
    name = torch.cuda.get_device_name(0)
    flops = float(np.mean([maskdit_train_flops_per_image("DiT-XL/2", res, r, True)
                           for r in ratios[every:]]))
    util = mfu(ips, flops, peak_bf16_tflops(name))
    util_fp32 = ips * flops / PEAK_FLOPS[torch.float32]
    peak = max(r["mem_peak_gib"] for r in history)
    fp32_share = f"; {util_fp32:.4f} of the fp32 peak, 67 TFLOP/s" if t.get("fp32") else ""
    log(f"[{tag}] warm steps {every + 1}-{steps}: {ips:.2f} images/s, "
        f"{seconds / warm_steps * 1e3:.1f} ms/step, MFU {util:.4f} of "
        f"{peak_bf16_tflops(name):.0f} TFLOP/s bf16 ({flops / 1e9:.1f} GFLOP/image{fp32_share}), "
        f"peak memory {peak:.2f} GiB; per window images/s "
        f"{[round(r['images_per_sec'], 2) for r in history]}")
    return dict(launches=launches, images_per_s=ips, ms_per_step=seconds / warm_steps * 1e3,
                mfu=util, mfu_fp32=util_fp32, peak_gib=peak, results=results,
                exp_dir=out["exp_dir"], losses=losses, digest=digest, moments=moments)


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
                       corners=None, **opt_kw):
    """A DiT-XL/2 train state with random weights and a non-trivial Adam
    state (count 10, mu ~ N(0, 1e-4^2), nu ~ |N(0, 1e-7^2)|), the same for
    the same seed; ``corners`` go to build_model, ``opt_kw`` to
    make_optimizer (the moments' dtypes)."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer

    torch.manual_seed(seed)
    with torch.device("cuda"):  # initialised on the card: the host's init is slower
        model = build_model(dtype, res, use_flash, **(corners or {})).cuda()
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
                      plain: bool = False, mask_ratio: float = 0.5,
                      pad_to_max: bool = False, corners=None, tag: str = "",
                      launches=None) -> dict:
    """One train step from train_parity_state's state at ``mask_ratio``
    (with ``pad_to_max``, the batch's): the loss, the gradients and the
    updated p/ema/mu/nu, through the kernels or (``plain``) the plain
    attention and update. With ``launches`` the kernels' step launched
    exactly those (checked under ``tag``)."""
    from maskdit_tpu_torch.train.state import make_train_step

    free_device_memory()
    state, opt = train_parity_state(dtype, 4, res, batch["x"].shape[0], use_flash, corners)
    step = make_train_step(opt, mask_ratio=mask_ratio, mae_loss_coef=0.1, ema_decay=0.9999,
                           pad_to_max=pad_to_max)
    ctx = contextlib.ExitStack()
    if plain:
        ctx.enter_context(plain_attention())
        ctx.enter_context(plain_update())
    with ctx:
        reset_launches()
        metrics = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    if launches is not None and not plain:
        expect_launches(tag, read_launches(), **launches)
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


def reset_parity_state_(state, seed: int) -> None:
    """train_parity_state's values again, in place: the weights of
    random_weights_ (written through the parameters, views of the flat
    buffer), the EMA equal to them, Adam's count 10 and its moments drawn
    from ``seed``."""
    random_weights_(state.model)
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        state.ema.copy_(state.params)
        state.opt_state.mu.normal_(0.0, 1e-4, generator=g)
        state.opt_state.nu.normal_(0.0, 1e-7, generator=g).abs_()
    state.opt_state.count, state.step = 10, 0


def remat_group(tag: str, res: int, n: int, launches, smi: str, use_flash=None,
                big_batch: int = 0) -> dict:
    """One train step of DiT-XL/2 (at the depth ``xl_depth`` gives, full
    width, bf16, mask 0.5) at ``res`` x ``res`` latents and batch ``n`` per
    remat policy, from one state (reset_parity_state_) with parity_batch's
    draws: loss, gradients and p / ema / mu / nu against the step without
    remat (bit for bit expected, else TRAIN_PARITY_BOUND[bf16]), the
    launches ``launches(policy)`` gives, the peak memory and ms/step (CUDA
    events over REMAT_TIMED_STEPS more steps); with ``big_batch``, then one
    step under 'full' at that batch."""
    from maskdit_tpu_torch.models.remat import policy_of
    from maskdit_tpu_torch.train.state import make_train_step

    free_device_memory()
    state, opt = train_parity_state(torch.bfloat16, 4, res, n, use_flash)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999)
    inner = state.model.model
    blocks = list(inner.blocks) + list(inner.decoder_blocks)
    model = (f"DiT-XL/2 @{res * 8} ({len(inner.blocks)} + {len(inner.decoder_blocks)} blocks, "
             f"full width){', use_flash' if use_flash else ''}")
    total = {name: 0 for name in kernel_counters()}

    def run(policy: str, batch, draws) -> tuple[dict, dict, float, int]:
        """One checked step under ``policy``: its metrics, launches, peak
        bytes and the bytes allocated before it."""
        for block in blocks:
            block.remat = policy_of(policy)
        reset_parity_state_(state, 4)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        metrics = step(state, batch, draws=draws)
        torch.cuda.synchronize()
        peak, counted = torch.cuda.max_memory_allocated(), read_launches()
        for k, v in counted.items():
            total[k] += v
        expect_launches(f"{tag} {policy}", counted, **launches(policy))
        return metrics, counted, peak, before

    def step_ms(batch, draws) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        reset_launches()
        start.record()
        for _ in range(REMAT_TIMED_STEPS):
            step(state, batch, draws=draws)
        end.record()
        torch.cuda.synchronize()
        for k, v in read_launches().items():
            total[k] += v
        return start.elapsed_time(end) / REMAT_TIMED_STEPS

    def result(loss: float, flats: dict) -> dict:
        return dict(loss=loss, grads=state.named(flats["grad"]), state={
            f"{name}.{k}": v for name in ("p", "ema", "mu", "nu")
            for k, v in state.named(flats[name]).items()})

    def counts(launched: dict) -> str:
        return " ".join(f"{KERNEL_NUMBERS[k]} {v}" for k, v in launched.items() if v)

    batch, draws = parity_batch(res, n)
    ref, ref_bytes, out = None, 0, {}
    for policy in REMAT_POLICIES:
        metrics, launched, peak, before = run(policy, batch, draws)
        loss = float(metrics["loss"])
        flats = {"grad": state.grads, "p": state.params, "ema": state.ema,
                 "mu": state.opt_state.mu, "nu": state.opt_state.nu}
        if ref is None:  # the step without remat
            ref = {"loss": loss, **{k: v.clone() for k, v in flats.items()}}
            ref_bytes = sum(v.numel() * v.element_size() for k, v in ref.items() if k != "loss")
            held, errs, exact = 0, dict(loss=0.0, grad=0.0, state=0.0), True
        else:  # the reference copies sit on the card through this step
            held = ref_bytes
            exact = loss == ref["loss"] and all(torch.equal(v, ref[k]) for k, v in flats.items())
            errs = dict(loss=0.0, grad=0.0, state=0.0) if exact else compare_steps(
                f"{tag} {policy}", "vs no remat", torch.bfloat16, res, n,
                result(loss, flats), result(ref["loss"], ref))
        ms = step_ms(batch, draws)
        out[policy] = dict(loss=loss, exact=exact, err=errs, launches=launched, ms=ms,
                           peak_gib=(peak - held) / 2**30, before_gib=(before - held) / 2**30)
        log(f"[{tag}] {policy}: {model}, bf16, batch {n}, mask 0.5: loss {loss:.6f} "
            + ("bit for bit with no remat (loss, every gradient, p / ema / mu / nu)" if exact
               else f"vs no remat rel err {errs['loss']:.3e}, grad {errs['grad']:.3e}, state "
               f"{errs['state']:.3e}") + f"; launches {counts(launched)}; peak "
            f"{peak / 2**30:.2f} GiB"
            + (f" with the no-remat reference ({held / 2**30:.2f} GiB), "
               f"{out[policy]['peak_gib']:.2f} without it" if held else "")
            + f" (state and batch before the step {out[policy]['before_gib']:.2f}); "
            f"{ms:.1f} ms/step (CUDA events, mean of {REMAT_TIMED_STEPS}); {smi}")
    del ref, flats
    free_device_memory()
    if big_batch:
        big, big_draws = parity_batch(res, big_batch)
        metrics, launched, peak, before = run("full", big, big_draws)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} full, batch {big_batch}: loss {loss}")
        ms = step_ms(big, big_draws)
        out["big"] = dict(loss=loss, launches=launched, peak_gib=peak / 2**30,
                          before_gib=before / 2**30, ms=ms, batch=big_batch)
        log(f"[{tag}] full at batch {big_batch} ({big_batch // n}x the released per-device "
            f"batch): loss {loss:.6f}; launches {counts(launched)}; peak {peak / 2**30:.2f} GiB "
            f"(state and batch before the step {before / 2**30:.2f}); {ms:.1f} ms/step (CUDA "
            f"events, mean of {REMAT_TIMED_STEPS}); {smi}")
    for block in blocks:
        block.remat = None
    del state, opt, step, metrics
    free_device_memory()
    out["launches"] = total
    return out


def phase_remat(smi: str) -> dict:
    """[remat]: remat_group on train256's model at full depth, batch
    TRAIN_BATCH, each policy one more #1 per block (the recomputed
    attention forward), then 'full' at REMAT_BIG_BATCH; [remat-512]:
    train512's model at full depth, batch TRAIN_BATCH_512, one more #3 per
    block; [remat-flash]: train512-flash's model (``use_flash``) at
    FLASH_DEPTH encoder blocks, batch TRAIN_BATCH_512, two #5 and one #6 per
    block under every policy as without remat (the block's recompute takes
    the place of the layer's checkpoint)."""
    def per_step(fwd: str, bwd: str, layers: int, extra: bool):
        return lambda policy: {fwd: layers * (2 if extra and policy != "none" else 1),
                               bwd: layers, "adam": ADAM_PER_STEP}

    out = remat_group("remat", 32, TRAIN_BATCH, per_step("packed_fwd", "packed_bwd",
                                                        ATTN_PER_STEP, True), smi,
                      big_batch=REMAT_BIG_BATCH)
    out["512"] = remat_group("remat-512", 64, TRAIN_BATCH_512, per_step(
        "big_fwd", "big_bwd", ATTN_PER_STEP, True), smi)
    with xl_depth(FLASH_DEPTH):
        out["flash"] = remat_group("remat-flash", 64, TRAIN_BATCH_512, lambda policy: {
            "flash_fwd": 2 * FLASH_ATTN_PER_STEP, "flash_bwd": FLASH_ATTN_PER_STEP,
            "adam": ADAM_PER_STEP}, smi, use_flash=True)
    out["launches"] = {k: sum(out[g]["launches"][k] for g in ("512", "flash"))
                       + v for k, v in out["launches"].items()}
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
            per_step = xl_blocks() + DECODER_DEPTH
            expect_launches("parity-train-options", launches, packed_fwd=2 * per_step,
                            packed_bwd=2 * per_step, adam=ADAM_PER_STEP)
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
    """The train CLI on TRAIN_CONFIG with TRAIN_OPTIONS: finite losses, one
    attention launch per block and micro-batch each way and one update per
    step; its ms/step, images/s and peak memory beside [train]'s. Since the
    tool twins came it runs under ``xl_depth(FLASH_DEPTH)``: it checks the
    options, not the depth."""
    layers = xl_blocks() + DECODER_DEPTH
    out = run_train("train-options", TRAIN_CONFIG, 32, dict(
        packed_fwd=TRAIN_OPTIONS_ACCUM * layers,
        packed_bwd=TRAIN_OPTIONS_ACCUM * layers, adam=ADAM_PER_STEP),
        TRAIN_OPTIONS, write_checkpoints=False)
    log(f"[train-options] {xl_blocks()} encoder blocks, global batch "
        f"{TRAIN_OPTIONS_MICRO * TRAIN_OPTIONS_ACCUM} "
        f"({TRAIN_OPTIONS_ACCUM} x {TRAIN_OPTIONS_MICRO}): {out['ms_per_step']:.1f} ms/step, "
        f"{out['images_per_s']:.2f} images/s, peak {out['peak_gib']:.2f} GiB; [train] "
        f"(full depth, batch {TRAIN_BATCH}, no options): {train['ms_per_step']:.1f} ms/step, "
        f"{train['images_per_s']:.2f} images/s, peak {train['peak_gib']:.2f} GiB")
    return out


def phase_train_staged(train: dict) -> dict:
    """The train CLI on TRAIN_CONFIG with ``train.fused_adam=false``: finite
    losses, one whole-row launch per block each way and no launch of kernel
    #7 per step, ms/step and peak memory beside [train]'s; then the same
    with bf16 mu and nu (the staged update's SR twin), nu stored in bf16.
    Since the tool twins came it runs under ``xl_depth(FLASH_DEPTH)``: it
    checks the option; ``profile_staged_update`` times the update over all
    of DiT-XL/2's parameters."""
    layers = xl_blocks() + DECODER_DEPTH
    per_step = dict(packed_fwd=layers, packed_bwd=layers)
    out = run_train("train-staged", TRAIN_CONFIG, 32, per_step, STAGED_OVERRIDES + (
        f"train.max_num_steps={TRAIN_STEPS_STAGED}",), write_checkpoints=False)
    nu = run_train("train-staged-nu", TRAIN_CONFIG, 32, per_step, STAGED_NU_OVERRIDES + (
        f"train.max_num_steps={TRAIN_STEPS_STAGED_NU}",), write_checkpoints=False)
    log(f"[train-staged-nu] moments stored as mu {nu['moments'][0]}, nu {nu['moments'][1]}")
    if nu["moments"] != ["bfloat16", "bfloat16"]:
        raise AssertionError(f"train-staged-nu: moments {nu['moments']}")
    out["nu"] = nu
    log(f"[train-staged] {xl_blocks()} encoder blocks: {out['ms_per_step']:.1f} ms/step, "
        f"{out['images_per_s']:.2f} images/s, peak {out['peak_gib']:.2f} GiB; with bf16 mu and "
        f"nu {nu['ms_per_step']:.1f} ms/step, peak {nu['peak_gib']:.2f} GiB; [train] (full "
        f"depth, kernel #7): {train['ms_per_step']:.1f} ms/step, peak {train['peak_gib']:.2f} GiB")
    return out


def profile_staged_update(adam: dict) -> dict:
    """The staged update over all of DiT-XL/2's parameters on random fp32
    state: its device ms (CUDA events) and one profiled update's kernels,
    beside kernel #7's fp32 ms ([kernel] fused adam)."""
    from maskdit_tpu_torch.ops import fused_adam

    free_device_memory()
    n = xl2_numel()
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda: torch.randn(n, generator=g, device="cuda")
    grads, p, e = rnd(), rnd(), rnd()
    m, v = rnd().mul_(0.1), rnd().abs_().mul_(1e-2)
    free_device_memory()
    kernel = adam[ADAM_VARIANTS[0]]["ms"]

    def update():
        fused_adam.staged_adam_ema(grads, p, m, v, e, lr=1e-4, count=6)

    ms = cuda_ms(update, 3)
    wall, busy = profile_device("train-staged-profile", update, 1,
                                f"the staged update over {n} params, fp32")
    log(f"[train-staged-profile] staged update: {ms:.3f} ms on the device (CUDA events, mean of "
        f"3; profiled busy {busy:.3f} ms of a {wall:.3f} ms wall); kernel #7 "
        f"({adam_variant_name(ADAM_VARIANTS[0])}) {kernel:.3f} ms: {ms / kernel:.2f}x; peak "
        f"{torch.cuda.max_memory_allocated() / 1024 ** 3:.2f} GiB")
    del grads, p, e, m, v
    free_device_memory()
    return dict(ms=ms, busy_ms=busy, wall_ms=wall, kernel_ms=kernel)


def phase_parity_train_staged(res: int = 32, n: int = PARITY_BATCH) -> dict:
    """One fp32 step of the parity model with the staged update against the
    fused kernel's step from the same state and draws (so the same
    gradients), within [parity-train]'s fp32 bounds, no #7 launch in the
    staged step; and the card's staged update against the staged update of
    a CPU copy of the state before it and of the step's own gradient, over
    the flat buffers' first STAGED_CPU_ELEMENTS (the update is elementwise:
    a slice's update is the update's slice)."""
    from maskdit_tpu_torch.ops import fused_adam
    from maskdit_tpu_torch.train.state import make_train_step

    batch, draws = parity_batch(res, n)
    per_step = xl_blocks() + DECODER_DEPTH
    attn = dict(packed_fwd=per_step, packed_bwd=per_step)
    fused = train_step_result(torch.float32, res, batch, draws, tag="parity-train-staged",
                              launches=dict(attn, adam=ADAM_PER_STEP))
    free_device_memory()
    state, opt = train_parity_state(torch.float32, 4, res, n, fused=False)
    before = [t[:STAGED_CPU_ELEMENTS].cpu()
              for t in (state.params, state.opt_state.mu, state.opt_state.nu, state.ema)]
    count = state.opt_state.count
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999)
    reset_launches()
    metrics = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    expect_launches("parity-train-staged", read_launches(), **attn)
    named = (("p", state.params), ("ema", state.ema), ("mu", state.opt_state.mu),
             ("nu", state.opt_state.nu))
    staged = dict(loss=float(metrics["loss"]),
                  grads={k: v.clone() for k, v in state.named(state.grads).items()},
                  state={f"{name}.{k}": v.clone() for name, flat in named
                         for k, v in state.named(flat).items()})
    out = {"vs_fused": compare_steps("parity-train-staged", "staged vs fused kernel #7",
                                     torch.float32, res, n, staged, fused)}
    del fused, staged
    p, m, v, e = before
    fused_adam.staged_adam_ema(state.grads[:STAGED_CPU_ELEMENTS].cpu(), p, m, v, e,
                               lr=opt.lr_at(count), count=count, b1=opt.b1, b2=opt.b2,
                               eps=opt.eps, ema_decay=0.9999)
    worst, exact = 0.0, True
    ends = [off + shape.numel() for _, shape, off in state.layout]
    for (_, flat), cpu in zip(named, (p, e, m, v)):
        card = flat[:STAGED_CPU_ELEMENTS].cpu()
        exact = exact and torch.equal(card, cpu)
        for lo, hi in zip([0] + ends, ends):  # each parameter the slice holds whole
            if hi > STAGED_CPU_ELEMENTS:
                break
            a, b = card[lo:hi], cpu[lo:hi]
            worst = max(worst, ((a - b).norm() / b.norm().clamp_min(1e-30)).item())
    bnd = TRAIN_PARITY_BOUND[torch.float32]["state"]
    log(f"[parity-train-staged] the card's staged update vs the same on a CPU copy of the state "
        f"and the step's gradient: max per-tensor p/ema/mu/nu rel-norm err {worst:.3e} (bound "
        f"{bnd:.0e}), bit for bit {exact}")
    if worst > bnd:
        raise AssertionError(f"parity-train-staged: card vs CPU staged update {worst}")
    out["vs_cpu"] = dict(err=worst, exact=exact)
    del state, opt, step, metrics, before
    free_device_memory()
    return out


@contextlib.contextmanager
def recorded_import():
    """What the trainer's import of a reference .pt did: the entries it
    reports the file lacks, whether every parameter the file holds now
    equals it, and whether the missing mask token kept the value it had
    before the import (the model's initialisation)."""
    from maskdit_tpu_torch.train.state import TrainState

    real = TrainState.load
    seen = {}

    def load(self, ckpt, strict=True):
        flats = {"model": self.params, "ema": self.ema}
        before = {e: self.named(f)["model.mask_token"].clone() for e, f in flats.items()}
        missing = real(self, ckpt, strict)
        named = {e: self.named(f) for e, f in flats.items()}
        seen.update(
            strict=strict, missing=missing,
            equal_to_file=all(torch.equal(named[e][k], v.to(named[e][k].device))
                              for e in flats for k, v in ckpt[e].items()),
            token_kept=all(torch.equal(named[e]["model.mask_token"], before[e]) for e in flats),
        )
        return missing

    TrainState.load = load
    try:
        yield seen
    finally:
        TrainState.load = real


@contextlib.contextmanager
def encoder_widths():
    """The token count the encoder hands the decoder in each forward (the
    kept tokens, or all of them unmasked), from a hook on every DecoderLayer."""
    from maskdit_tpu_torch.models.layers import DecoderLayer

    widths = []
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda mod, args: widths.append(args[0].shape[1]) if isinstance(mod, DecoderLayer)
        else None)
    try:
        yield widths
    finally:
        handle.remove()


def finetune_plan(config: dict) -> tuple[list, list, dict]:
    """Each step's bucketed mask ratio and kept token count, recomputed from
    the port's schedules as the trainer steps through them, and the
    launches the steps' attention routes (encoder at the kept tokens, hd 72;
    decoder at all of them, hd 32; with a backward and the config's
    ``model.use_flash``) and updates give: a 'flash' layer launches its
    forward twice (the checkpoint's recompute)."""
    from maskdit_tpu_torch.models.layers import attention_route
    from maskdit_tpu_torch.models.masking import len_keep_for
    from maskdit_tpu_torch.train.schedules import bucket_ratio, get_mask_ratio_fn

    m, steps = config["model"], config["train"]["max_num_steps"]
    full = (m["in_size"] // 2) ** 2
    fn = get_mask_ratio_fn(m["mask_ratio_fn"], m["mask_ratio"], m["mask_ratio_min"])
    ratios = [bucket_ratio(fn(s / steps), full) for s in range(steps)]
    kept = [len_keep_for(full, r) for r in ratios]
    launches = {"adam": ADAM_PER_STEP * steps}
    for l in kept:
        for length, hd, blocks in ((l, 72, DEPTH), (full, 32, DECODER_DEPTH)):
            route = attention_route(16, length, hd, True, m.get("use_flash"))
            if route not in ("packed", "big", "flash"):
                raise AssertionError(f"finetune: L {length} hd {hd} routes to {route}")
            for way, calls in (("fwd", 2 if route == "flash" else 1), ("bwd", 1)):
                launches[f"{route}_{way}"] = launches.get(f"{route}_{way}", 0) + calls * blocks
    return ratios, kept, launches


def phase_finetune(tag: str, name: str, overrides=()) -> dict:
    """The finetune main path: configs/finetune/imagenet<name>.yaml through
    the train CLI as released (``--ckpt_path FINETUNE_CKPT --use_strict_load
    False``) with the config ``overrides``, fp32 at full width and depth.
    Checks finite losses, the launches of each step's route and one update
    per step and no other kernel, each step's kept token count against the
    schedule, TF32 off after the run, and the import: non-strict, the mask
    token alone missing and kept at its initialisation, every other
    parameter (model and EMA) equal to the file's."""
    from maskdit_tpu_torch.train.cli import apply_overrides

    config, _ = FINETUNE_CONFIGS[name]
    res = config["model"]["in_size"]
    ratios, kept, launches = finetune_plan(apply_overrides(json.loads(json.dumps(config)),
                                                           overrides))
    with recorded_import() as imported, encoder_widths() as widths:
        out = run_train(tag, config, res, {}, overrides, options=(
            "--ckpt_path", FINETUNE_CKPT, "--use_strict_load", "False"), extra=launches,
            write_checkpoints=False, ratios=ratios)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    log(f"[{tag}] kept tokens per step {widths} (schedule: {kept}); TF32 (matmul, cuDNN, "
        f"precision) {tf32}; import: strict {imported.get('strict')}, missing "
        f"{imported.get('missing')}, mask token kept at its initialisation "
        f"{imported.get('token_kept')}, every other parameter equal to the file's "
        f"{imported.get('equal_to_file')}")
    if widths != kept:
        raise AssertionError(f"{tag}: kept tokens {widths} != the schedule's {kept}")
    if tf32 != (False, False, "highest"):
        raise AssertionError(f"{tag}: TF32 {tf32}")
    if not (imported.get("strict") is False and imported["token_kept"]
            and imported["equal_to_file"]
            and imported["missing"] == ["model.model.mask_token", "ema.model.mask_token"]):
        raise AssertionError(f"{tag}: import {imported}")
    return dict(out, kept=kept, ratios=ratios)


def phase_parity_train_finetune() -> dict:
    """[parity-train-finetune]: one fp32 step at PARITY_BATCH from one state
    with the same injected draws, within [parity-train]'s fp32 bounds: the
    kernels against the plain attention and update at mask 0 (L 256) and at
    a cos4 bucket, and the pad-to-max step (plain attention with the key
    mask in the encoder, L 256) against the packed step at that ratio."""
    from maskdit_tpu_torch.models.masking import MaskInfo, random_mask

    tag, fp32, n = "parity-train-finetune", torch.float32, PARITY_BATCH
    batch, draws = parity_batch(32, n)
    ratios, kept, _ = finetune_plan(FINETUNE_COS_CONFIG)
    ratio, len_keep = ratios[FINETUNE_PARITY_STEP], kept[FINETUNE_PARITY_STEP]
    packed = random_mask(n, 256, ratio, torch.Generator(device="cuda").manual_seed(4),
                         device="cuda")
    padded = MaskInfo(packed.mask, torch.argsort(packed.ids_restore, dim=1), packed.ids_restore,
                      torch.tensor(len_keep, device="cuda"))
    out = {}
    unmasked = draws._replace(mask_info=None)
    got = train_step_result(fp32, 32, batch, unmasked, mask_ratio=0.0)
    ref = train_step_result(fp32, 32, batch, unmasked, mask_ratio=0.0, plain=True)
    out["mask0"] = compare_steps(tag, "mask 0 (L 256), kernels vs plain", fp32, 32, n, got, ref)
    del got, ref
    bucket = draws._replace(mask_info=packed)
    got = train_step_result(fp32, 32, batch, bucket, mask_ratio=ratio)
    ref = train_step_result(fp32, 32, batch, bucket, mask_ratio=ratio, plain=True)
    out["cos4"] = compare_steps(tag, f"cos4 bucket {ratio} (L {len_keep}), kernels vs plain",
                                fp32, 32, n, got, ref)
    del ref
    pad = train_step_result(fp32, 32, {**batch, "mask_ratio": ratio},
                            draws._replace(mask_info=padded), pad_to_max=True)
    out["pad_to_max"] = compare_steps(tag, f"pad-to-max (L 256, {len_keep} valid) vs packed at "
                                      f"ratio {ratio}", fp32, 32, n, pad, got)
    del got, pad
    free_device_memory()
    return out


def phase_parity_train_finetune_flash() -> dict:
    """[parity-train-finetune-flash]: one fp32 step at mask 0 (L 1024) of
    the 512-px finetune's model with ``use_flash`` (run under
    ``xl_depth(FLASH_DEPTH)``), at PARITY_BATCH_512, from one state with
    the same injected draws, within the fp32 train bounds: the flash
    kernels' step (2 forward launches and 1 backward per layer, 1 update)
    against the plain attention and update, and against the default step on
    the blocked kernels #3 / #4."""
    tag, fp32, n, res = "parity-train-finetune-flash", torch.float32, PARITY_BATCH_512, 64
    batch, draws = parity_batch(res, n)
    unmasked = draws._replace(mask_info=None)
    layers = FLASH_ATTN_PER_STEP
    got = train_step_result(fp32, res, batch, unmasked, use_flash=True, mask_ratio=0.0, tag=tag,
                            launches=dict(flash_fwd=2 * layers, flash_bwd=layers,
                                          adam=ADAM_PER_STEP))
    ref = train_step_result(fp32, res, batch, unmasked, use_flash=True, mask_ratio=0.0,
                            plain=True)
    out = {"plain": compare_steps(tag, "use_flash at mask 0 (L 1024), kernels vs plain", fp32,
                                  res, n, got, ref)}
    del ref
    ref = train_step_result(fp32, res, batch, unmasked, mask_ratio=0.0, tag=tag,
                            launches=dict(big_fwd=layers, big_bwd=layers, adam=ADAM_PER_STEP))
    out["blocked"] = compare_steps(tag, "use_flash vs the blocked kernels at mask 0", fp32, res,
                                   n, got, ref)
    del got, ref
    free_device_memory()
    return out


def write_cls_checkpoint(ckpt: str) -> None:
    """CLS_CKPT: [weights]' tensors (of the encoder blocks the model is
    built with) and, for the class token and the two embedders a class
    token and self-conditioning add (cls_token_embedder, enc_feat_embedder),
    N(0, 0.02^2) ones from seed 1, in the reference ``{"ema": ...}``
    layout."""
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    state = xl_state(load_reference_checkpoint(ckpt))
    g = torch.Generator().manual_seed(1)
    d = 1152
    for key, shape in (("cls_token", (1, 1, d)), ("cls_token_embedder.weight", (d, d)),
                       ("cls_token_embedder.bias", (d,)), ("enc_feat_embedder.weight", (d, d)),
                       ("enc_feat_embedder.bias", (d,))):
        state[f"model.{key}"] = torch.randn(shape, generator=g) * 0.02
    torch.save({"ema": state}, CLS_CKPT)


def phase_sample_cls(ckpt: str) -> dict:
    """[sample-cls]: the generate CLI on configs/test/maskdit-256.yaml's model
    with ``pad_cls_token`` and ``self_cond`` (SAMPLE_CLS_CONFIG, as JSON)
    from CLS_CKPT, 8 seeds, CFG 1.5, 40 steps. Each of the 79 evaluations
    runs the encoder for the pooled feature (one whole-row forward per
    encoder block at the CFG batch of 16, L 257: 28 at full depth) and then
    the model (as many more at L 257 and 8 in the decoder at L 256, hd 32):
    checked to the launch. Then one CFG
    evaluation of that model, kernels vs plain, in bf16 and fp32, within
    MODEL_REL_BOUND."""
    from maskdit_tpu_torch.models.layers import attention_route
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    t0 = time.perf_counter()
    write_cls_checkpoint(ckpt)
    config = os.path.join(SCRATCH, "maskdit-256-cls.json")
    with open(config, "w") as f:
        json.dump(SAMPLE_CLS_CONFIG, f)
    routes = (attention_route(16, 257, 72, False), attention_route(16, 256, 32, False))
    log(f"[sample-cls] {CLS_CKPT} written in {time.perf_counter() - t0:.1f} s; routes: encoder "
        f"(16, 257, 72) '{routes[0]}', decoder (16, 256, 32) '{routes[1]}'")
    argv = [
        "--ckpt_path", CLS_CKPT, "--outdir", os.path.join(SCRATCH, "samples-cls"), "--no_decode",
        "--config", config, "--seeds", f"0-{SEEDS - 1}", "--max_batch_size", str(SEEDS),
        "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
    ]
    per_eval = 2 * xl_blocks() + DECODER_DEPTH
    out, launches = run_generate("sample-cls", argv, SEEDS, 32)
    expect_launches("sample-cls", launches, packed_fwd=(2 * STEPS - 1) * per_eval)
    state = load_reference_checkpoint(CLS_CKPT)
    x, sigma, y = denoiser_inputs(SEEDS, 32)
    for dtype in (torch.bfloat16, torch.float32):
        model = parity_model(state, dtype, 32, pad_cls_token=True, use_encoder_feat=True)
        out[dtype_name(dtype)] = check_denoiser("sample-cls", model, x, sigma, y,
                                                packed_fwd=per_eval)
        del model
    del state
    free_device_memory()
    return dict(out, launches=launches)


def write_features() -> int:
    """The feature LMDB at FEATURE_ROOT: one FEATURE_DIM-float row from
    N(0, 1) (FEATURE_SEED) per record of [extract]'s latent LMDB, under its
    label. Returns the record count."""
    from maskdit_tpu_torch.data.features import write_feature_lmdb
    from maskdit_tpu_torch.data.native_io import open_reader

    db = open_reader(os.path.join(TRAIN_DATA_ROOT, "train"))
    n = int(db.get(b"length").decode())
    labels = [int(db.get(f"y-{i}".encode()).decode()) for i in range(n)]
    db.close()
    feats = np.random.default_rng(FEATURE_SEED).standard_normal((n, FEATURE_DIM), np.float32)
    write_feature_lmdb(os.path.join(FEATURE_ROOT, "train"), feats, labels)
    return n


@contextlib.contextmanager
def corner_inputs():
    """The token counts the encoder's blocks take (DiTBlocks of XL/2's
    width) and the shapes the feature embedder (the Linear of FEATURE_DIM
    inputs) takes, from forward hooks."""
    from maskdit_tpu_torch.models.layers import DiTBlock, Linear

    seen = {"encoder": set(), "feat": []}

    def hook(mod, args):
        if isinstance(mod, DiTBlock) and args[0].shape[-1] == 1152:
            seen["encoder"].add(args[0].shape[1])
        elif isinstance(mod, Linear) and mod.in_features == FEATURE_DIM:
            seen["feat"].append(tuple(args[0].shape))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def phase_train_cls_feat() -> dict:
    """[train-cls-feat]: the train CLI on TRAIN_CLS_CONFIG: the released
    256-px config with a class token and FEATURE_DIM-wide features joined
    from the feature LMDB, batch 128, mask 0.5, TRAIN_STEPS_CLS steps.
    Finite losses; per step one whole-row forward and backward per block
    (36 at full depth: the encoder at 128 kept tokens + the class token,
    the decoder at 256) and one update, no other kernel; the encoder took
    129 tokens and the feature embedder a (128, FEATURE_DIM) batch at every
    step."""
    from maskdit_tpu_torch.models.layers import attention_route

    t0 = time.perf_counter()
    n = write_features()
    routes = (attention_route(16, 129, 72, True), attention_route(16, 256, 32, True))
    log(f"[train-cls-feat] feature LMDB: {n} records of {FEATURE_DIM} floats (seed "
        f"{FEATURE_SEED}) in {time.perf_counter() - t0:.1f} s; routes with a backward: encoder "
        f"(16, 129, 72) '{routes[0]}', decoder (16, 256, 32) '{routes[1]}'")
    with corner_inputs() as seen:
        blocks = xl_blocks() + DECODER_DEPTH
        out = run_train("train-cls-feat", TRAIN_CLS_CONFIG, 32, dict(
            packed_fwd=blocks, packed_bwd=blocks, adam=ADAM_PER_STEP),
            write_checkpoints=False)
    log(f"[train-cls-feat] encoder token counts {sorted(seen['encoder'])}; feature batches "
        f"{seen['feat']}")
    if (seen["encoder"] != {129}
            or seen["feat"] != [(TRAIN_BATCH, FEATURE_DIM)] * TRAIN_STEPS_CLS):
        raise AssertionError(f"train-cls-feat: {seen}")
    return out


def phase_parity_cls() -> dict:
    """[parity-cls]: one fp32 step of [train-cls-feat]'s model (class token,
    FEATURE_DIM features) at PARITY_BATCH from one state with the same
    injected draws and features, kernels vs plain, within [parity-train]'s
    fp32 bounds: at mask 0.5 (the encoder at L 129 on #1 / #2) and at mask 0
    (L 257 on #3 / #4; the decoder on #1 / #2 at L 256), the kernels' step
    checked to the launch."""
    tag, fp32, n = "parity-cls", torch.float32, PARITY_BATCH
    batch, draws = parity_batch(32, n)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch["feat"] = torch.randn(n, FEATURE_DIM, device="cuda", generator=g)
    enc, dec = xl_blocks(), DECODER_DEPTH
    out = {}
    for ratio, d, launches in (
            (0.5, draws, dict(packed_fwd=enc + dec, packed_bwd=enc + dec, adam=1)),
            (0.0, draws._replace(mask_info=None),
             dict(big_fwd=enc, big_bwd=enc, packed_fwd=dec, packed_bwd=dec, adam=1))):
        what = f"mask {ratio} (L {129 if ratio else 257}), kernels vs plain"
        got = train_step_result(fp32, 32, batch, d, mask_ratio=ratio, corners=CLS_MODEL_KW,
                                tag=f"{tag} mask {ratio}", launches=launches)
        ref = train_step_result(fp32, 32, batch, d, mask_ratio=ratio, corners=CLS_MODEL_KW,
                                plain=True)
        out[f"mask{ratio}"] = compare_steps(tag, what, fp32, 32, n, got, ref)
        del got, ref
    free_device_memory()
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
    per_rank = dict(packed_fwd=DDP_ATTN_PER_STEP * DDP_STEPS,
                    packed_bwd=DDP_ATTN_PER_STEP * DDP_STEPS, adam=DDP_STEPS)
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
    with xl_depth(DDP_DEPTH):
        alone = run_train("train-ddp-alone", TRAIN_CONFIG, 32, dict(
            packed_fwd=DDP_ATTN_PER_STEP, packed_bwd=DDP_ATTN_PER_STEP, adam=ADAM_PER_STEP),
            (f"train.batchsize={DDP_BATCH}", *DDP_OVERRIDES), write_checkpoints=False,
            digest=True)
    expect_launches("train-ddp-nccl", out["launches"], packed_fwd=DDP_ATTN_PER_STEP * DDP_STEPS,
                    packed_bwd=DDP_ATTN_PER_STEP * DDP_STEPS, adam=DDP_STEPS)
    same = out["digests"] == [alone["digest"]] and out["losses"] == alone["losses"]
    log(f"[train-ddp-nccl] backend {out['backend']}: parameters {out['digests'][0][:16]} vs "
        f"without a group {alone['digest'][:16]}, losses equal "
        f"{out['losses'] == alone['losses']}: bit for bit {same}; "
        f"{out['ms_per_step']:.1f} vs {alone['ms_per_step']:.1f} ms/step")
    if not same:
        raise AssertionError(f"train-ddp-nccl: {out} vs {alone}")
    out["alone"] = alone
    return out


@contextlib.contextmanager
def xl_depth(depth: int):
    """DiT-XL/2 built with ``depth`` encoder blocks (full width) inside."""
    from maskdit_tpu_torch.models import dit

    config = dit.DIT_CONFIGS["DiT-XL/2"]
    was, config["depth"] = config["depth"], depth
    try:
        yield
    finally:
        config["depth"] = was


def xl_blocks() -> int:
    """DiT-XL/2's encoder blocks as the model is built now (``xl_depth``
    may cut them)."""
    from maskdit_tpu_torch.models import dit

    return dit.DIT_CONFIGS["DiT-XL/2"]["depth"]


def xl_state(state: dict) -> dict:
    """A full-depth state dict without the encoder blocks the model is built
    without now."""
    dropped = tuple(f"model.blocks.{i}." for i in range(xl_blocks(), DEPTH))
    return {k: v for k, v in state.items() if not k.startswith(dropped)}


def worker(tag: str, result: str, *args: str) -> None:
    """One process of a data-parallel phase, under torch.distributed.run, on
    DiT-XL/2 at DDP_DEPTH encoder blocks."""
    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.parallel.data_parallel import DataParallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with xl_depth(DDP_DEPTH):
        if tag == "parity-ddp":
            dist.init_distributed(backend="gloo", device="cuda:0")
            out = worker_parity_ddp(DataParallel())
        elif tag in ("train-ddp", "train-ddp-nccl"):
            gloo = tag == "train-ddp"
            device = "cuda:0" if gloo else "cuda"
            dist.init_distributed(backend="gloo" if gloo else "nccl", device=device)
            out = worker_train(device, gloo)
        elif tag == "mesh":
            dist.init_distributed(backend="gloo", device="cuda:0")
            out = worker_mesh()
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
        log(f"[parity-ddp] 2 ranks x {n // 2} rows vs one process x {n}, DiT-XL/2 @256 at "
            f"{DDP_DEPTH} encoder blocks, fp32: "
            f"loss rel err {out['loss']:.3e}, max per-tensor gradient rel-norm err "
            f"{out['grad']:.3e}, p/ema/mu/nu {out['state']:.3e} (worst {out['worst']})")
    tdist.barrier()
    return out


def gloo_on_cuda_tensors() -> dict:
    """Which collectives the gloo backend of this torch takes on CUDA
    tensors (``parallel/mesh.py`` calls all five on them): for each, "ok"
    with its value checked, or the error it raised."""
    import torch.distributed as tdist

    world, rank = tdist.get_world_size(), tdist.get_rank()
    total = float(sum(range(1, world + 1)))

    def all_reduce():
        x = torch.full((4,), float(rank + 1), device="cuda")
        tdist.all_reduce(x)
        return bool(torch.all(x == total))

    def broadcast():
        x = torch.full((4,), float(rank + 1), device="cuda")
        tdist.broadcast(x, src=0)
        return bool(torch.all(x == 1.0))

    def all_gather_into_tensor():
        out = torch.empty(world * 4, device="cuda")
        tdist.all_gather_into_tensor(out, torch.full((4,), float(rank + 1), device="cuda"))
        return bool(torch.equal(out.view(world, 4)[:, 0].cpu(), torch.arange(1.0, world + 1)))

    def reduce_scatter_tensor():
        out = torch.empty(4, device="cuda")
        tdist.reduce_scatter_tensor(out, torch.full((world * 4,), float(rank + 1),
                                                    device="cuda"))
        return bool(torch.all(out == total))

    def all_gather():
        outs = [torch.empty(4, device="cuda") for _ in range(world)]
        tdist.all_gather(outs, torch.full((4,), float(rank + 1), device="cuda"))
        return all(float(o[0]) == i + 1 for i, o in enumerate(outs))

    out = {}
    for call in (all_reduce, broadcast, all_gather_into_tensor, reduce_scatter_tensor,
                 all_gather):
        try:
            out[call.__name__] = "ok" if call() else "wrong values"
        except Exception as err:  # recorded: what this torch's gloo refuses
            out[call.__name__] = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
        tdist.barrier()
    return out


def mesh_reference(case: tuple) -> tuple:
    """One process's step of a MESH_PARITY case: the start state (the state
    dicts of train_parity_state), the step's gradient and p / ema / mu / nu
    per parameter (views of its flat buffers) and its loss, on the card."""
    from maskdit_tpu_torch.train.state import make_train_step

    name, res, n, shape, dtype, nu, remat, use_flash = case
    batch, draws = parity_batch(res, n)
    state, opt = train_parity_state(dtype, 4, res, n, use_flash, {"remat": remat}, nu_dtype=nu)
    copy = lambda flat: {k: v.detach().clone() for k, v in state.named(flat).items()}
    start = {"model": copy(state.params), "ema": copy(state.ema),
             "opt": {"count": state.opt_state.count, "mu": copy(state.opt_state.mu),
                     "nu": copy(state.opt_state.nu)}}
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999)
    metrics = step(state, batch, draws=draws)
    ref = {"grad": state.named(state.grads), "p": state.named(state.params),
           "ema": state.named(state.ema), "mu": state.named(state.opt_state.mu),
           "nu": state.named(state.opt_state.nu)}
    loss = float(metrics["loss"])
    del state, opt, step, metrics, batch, draws
    free_device_memory()
    return start, ref, loss


def mesh_case(case: tuple, held: dict) -> dict:
    """[parity-mesh] one case in one rank: this rank's sharded state from
    the reference's start, one step on its rows with the reference's draws
    (its launches counted; above the allocation at its start, the memory
    allocated at the backward's first gather and when the backward is
    done, the peak up to the root's reduction and the step's; the most
    bytes its units' parameter and gradient buffers held at once, at each
    gather, reduction and release, against ``unit_bytes``' bound; its
    wall time), then per parameter
    the rel-norm error of the gradient and of p / ema / mu / nu from every
    rank's shards (each leaf's sums over its replicas in the fsdp x tensor
    group counted once); a bf16 nu of an fp32 model also per element within
    one bf16 ulp; a case of MESH_SAME_AS bit for bit with its case's shards,
    which ``held`` keeps on the host. And this rank's state on the card
    (allocated) against the bytes of its shards by the rules."""
    import math

    import torch.distributed as tdist

    from maskdit_tpu_torch.parallel import mesh as mesh_lib
    from maskdit_tpu_torch.parallel.sharded import (create_sharded_state,
                                                    make_sharded_train_step, tensor_split_of)
    from maskdit_tpu_torch.train.state import StepDraws, _rows, make_optimizer

    name, res, n, shape, dtype, nu, remat, use_flash = case
    t0 = time.perf_counter()
    start, ref, ref_loss = mesh_reference(case)
    mesh = mesh_lib.create_mesh(shape)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with torch.device("cuda"):  # initialised on the card: the shards replace its values
        model = build_model(dtype, res, use_flash, tensor_split=tensor_split_of(mesh),
                            remat=remat).cuda()
    opt = make_optimizer(1e-4, n, nu_dtype=nu)
    state = create_sharded_state(model, start["model"], opt, mesh)
    torch.cuda.synchronize()
    held_bytes = torch.cuda.memory_allocated() - before
    per_element = 4 * 4 + (2 if nu else 4)  # params, grads, ema, mu in fp32; nu
    reckoned = sum(math.prod(leaf.shard_shape) for leaf in state.shard_layout.leaves) * per_element
    full_bytes = state.shard_layout.full_numel * per_element
    state.load({"ema": start["ema"], "opt": start["opt"]})  # the parameters: ``full`` above
    del start
    step = make_sharded_train_step(opt, mesh, mask_ratio=0.5, mae_loss_coef=0.1,
                                   ema_decay=0.9999)
    batch, draws = parity_batch(res, n)
    rows = slice(mesh.batch_index * n // mesh.batch_count,
                 (mesh.batch_index + 1) * n // mesh.batch_count)
    batch = {k: v[rows] for k, v in batch.items()}
    draws = StepDraws(*(_rows(d, rows) for d in draws))
    marks = {"units_alive": 0}
    gather, end_micro = state.gather, state.end_micro
    nbytes = lambda t: t.untyped_storage().nbytes()

    def gather_marked(unit):  # the backward's gathers run without grad mode
        if not torch.is_grad_enabled() and "backward_start" not in marks:
            marks["backward_start"] = torch.cuda.memory_allocated()
        gather(unit)

    def end_marked(acc_dtype):
        marks["backward_end"] = torch.cuda.memory_allocated()
        marks["peak_to_reduction"] = torch.cuda.max_memory_allocated()
        marks["units_gathered"] = sum(nbytes(u.full) for u in state.units)
        end_micro(acc_dtype)

    def alive_marked(fn, after: bool):  # the units' buffers with storage, at each event
        def run(unit):
            if after:
                fn(unit)
            marks["units_alive"] = max(marks["units_alive"], sum(
                nbytes(u.full) + nbytes(u.grad) for u in state.all_units))
            if not after:
                fn(unit)
        return run

    state.gather, state.end_micro = gather_marked, end_marked
    state.open_for_backward = alive_marked(state.open_for_backward, True)
    state.reduce = alive_marked(state.reduce, False)
    state.release = alive_marked(state.release, False)
    units_bound, staging = unit_bytes(state)
    tdist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()  # the state, the batch, the reference
    reset_launches()
    t_step = time.perf_counter()
    metrics = step(state, batch, draws=draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_step) * 1e3
    launches, peak = read_launches(), torch.cuda.max_memory_allocated() - at_start
    marks = {k: v if k.startswith("units_") else v - at_start for k, v in marks.items()}
    del state.gather, state.end_micro, state.open_for_backward, state.reduce, state.release
    loss = float(metrics["loss"])
    flats = {"grad": state.grads, "p": state.params, "ema": state.ema,
             "mu": state.opt_state.mu, "nu": state.opt_state.nu}
    same = True
    if name in MESH_SAME_AS:
        base = held.pop(MESH_SAME_AS[name])
        same = loss == base["loss"] and all(torch.equal(v.cpu(), base[k])
                                            for k, v in flats.items())
        del base
    elif name in MESH_SAME_AS.values():
        held[name] = {"loss": loss, **{k: v.cpu() for k, v in flats.items()}}
    layout = state.shard_layout
    weights = torch.tensor([1.0 / leaf.replicas for leaf in layout.leaves], dtype=torch.float64,
                           device="cuda")
    errs, ulp_ok, nu_equal = {}, True, True
    for what, flat in (("grad", state.grads), ("p", state.params), ("ema", state.ema),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        mine = layout.named(flat)
        want = layout.shard(ref.pop(what))
        sums = torch.zeros(len(layout.leaves), 2, dtype=torch.float64, device="cuda")
        for i, leaf in enumerate(layout.leaves):
            a, b = mine[leaf.name], want[leaf.name]
            sums[i, 0] = (a.double() - b.double()).square().sum()
            sums[i, 1] = b.double().square().sum()
            if what == "nu" and nu and dtype == torch.float32:
                ulp = torch.finfo(torch.bfloat16).eps * b.float().abs()
                ulp_ok = ulp_ok and bool(((a.float() - b.float()).abs() <= ulp).all())
                nu_equal = nu_equal and torch.equal(a, b)
        del want
        sums = (sums * weights[:, None]).cpu()
        if mesh_lib.group_size(mesh, "model") > 1:
            tdist.all_reduce(sums, group=mesh.groups["model"])
        rel = (sums[:, 0] / sums[:, 1].clamp_min(1e-60)).sqrt()
        worst = int(rel.argmax())
        errs[what] = (float(rel[worst]), layout.leaves[worst].name)
    flags = torch.tensor([int(ulp_ok), int(nu_equal), int(same)])
    tdist.all_reduce(flags, op=tdist.ReduceOp.MIN)
    out = dict(
        loss=abs(loss - ref_loss) / abs(ref_loss), grad=errs["grad"][0],
        worst_grad=errs["grad"][1],
        state=max(v[0] for k, v in errs.items() if k != "grad" and not (k == "nu" and nu)),
        nu=errs["nu"][0], nu_within_ulp=bool(flags[0]), nu_equal=bool(flags[1]),
        same_as=bool(flags[2]), launches=launches, held_bytes=held_bytes,
        reckoned_bytes=reckoned, full_bytes=full_bytes, peak=peak, ms=ms, **marks,
        units_bound=units_bound, staging=staging,
        segments=int(layout.segments.shape[0]), seconds=time.perf_counter() - t0,
    )
    del state, opt, step, model, metrics, ref, flats
    free_device_memory()
    return out


def unit_bytes(state) -> tuple[int, int]:
    """From a sharded state's layout: the bytes its units' parameter and
    gradient buffers may hold at once in a backward (the root and the two
    largest blocks, each twice: parameters and gradient, in the gradient's
    dtype), and the largest unit's fp32 reduction staging (the reduce-scatter's
    send, which holds each leaf not split over fsdp once per fsdp rank, and
    its result)."""
    units: dict[str, int] = {}
    stage: dict[str, int] = {}
    for leaf in state.shard_layout.leaves:
        block = re.match(r"(model\.(?:decoder_)?blocks\.\d+)\.", leaf.name)
        name = block.group(1) if block else "root"
        units[name] = units.get(name, 0) + leaf.local_numel
        copies = 1 if leaf.dim_f is not None else state.mesh.shape["fsdp"]
        stage[name] = stage.get(name, 0) + copies * leaf.local_numel + leaf.shard_numel
    root = units.pop("root")
    size = state.root.grad.element_size()
    return 2 * size * (root + sum(sorted(units.values())[-2:])), 4 * max(stage.values())


def parity_mesh() -> dict:
    """[parity-mesh] in one rank: the gloo probe and each MESH_PARITY case,
    with every rank's per-rank numbers."""
    import torch.distributed as tdist

    from maskdit_tpu_torch.parallel import dist

    out = {"gloo_cuda": gloo_on_cuda_tensors(), "parity": {}}
    held = {}  # the shards of MESH_SAME_AS's cases, on the host
    per_rank = ("launches", "held_bytes", "reckoned_bytes", "peak", "ms", "backward_start",
                "backward_end", "peak_to_reduction", "units_gathered", "units_alive",
                "units_bound", "staging")
    for case in MESH_PARITY:
        got = mesh_case(case, held)
        everyone = [None] * dist.process_count()
        tdist.all_gather_object(everyone, [got[k] for k in per_rank])
        got.update({k: [e[i] for e in everyone] for i, k in enumerate(per_rank)})
        out["parity"][case[0]] = got
        dist.mprint(f"[parity-mesh] {case[0]}: {got}", flush=True)
        tdist.barrier()
    return out


def worker_mesh() -> dict:
    """[parity-mesh] then [train-mesh] in one rank (MESH_RANKS gloo ranks on
    the card): the gloo probe, each MESH_PARITY case, then the train CLI
    with --mesh MESH_TRAIN (its last checkpoint written): every rank's
    launches and peak memory, and the digest of the gathered parameters."""
    import io
    import torch.distributed as tdist

    from maskdit_tpu_torch.parallel import dist
    from maskdit_tpu_torch.train import main as train_main

    torch.cuda.set_device(0)
    world = dist.process_count()
    out = parity_mesh()
    path = os.path.join(SCRATCH, "train-mesh-config.json")
    if dist.is_main_process():
        with open(path, "w") as f:
            json.dump(TRAIN_CONFIG, f)
    dist.barrier()
    captured = io.StringIO()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t_train = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        run = train_main(["--config", path, "--results_dir", os.path.join(SCRATCH, "train-mesh"),
                          "--device", "cuda:0", "--dist_backend", "gloo", "--num_workers", "2",
                          "--mesh", MESH_TRAIN, f"train.batchsize={MESH_TRAIN_BATCH}",
                          f"train.max_num_steps={MESH_TRAIN_STEPS}"])
    text = captured.getvalue()
    print(text, end="", flush=True)
    launches, peak = read_launches(), torch.cuda.max_memory_allocated() / 2**30
    state = run["state"]
    full = state.full_named(state.params)
    digest = params_digest(torch.cat([v.reshape(-1) for v in full.values()]))
    everyone = [None] * world
    tdist.all_gather_object(everyone, (launches, peak))
    history = run["history"]
    warm = history[1:] or history
    out["train_seconds"] = time.perf_counter() - t_train
    out["train"] = dict(
        exp_dir=run["exp_dir"], step=run["step"], digest=digest,
        losses=[x for r in history for x in r["losses"]],
        launches=[e[0] for e in everyone], peak_gib=[e[1] for e in everyone],
        ms_per_step=sum(LOG_EVERY / r["steps_per_sec"] for r in warm)
        / (LOG_EVERY * len(warm)) * 1e3,
    )
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
                        reps: int = 3, use_flash=None, fp32: bool = False,
                        mask_ratio: float = 0.5) -> float:
    """Device time by kernel over warm train steps at the main path's batch
    (bf16, or ``fp32``; mask ``mask_ratio``), from torch.profiler; returns
    the device busy ms per step."""
    from maskdit_tpu_torch.data.datasets import SyntheticLatentDataset
    from maskdit_tpu_torch.data.loader import DataLoader
    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step

    free_device_memory()
    torch.manual_seed(0)
    with torch.device("cuda"):  # initialised on the card: the host's init is slower
        model = create_model("edm", img_resolution=res, img_channels=4, num_classes=1000,
                             model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1,
                             use_flash=use_flash,
                             dtype=torch.float32 if fp32 else torch.bfloat16).cuda()
    opt = make_optimizer(1e-4, batch)
    state = create_train_state(model, opt)
    step = make_train_step(opt, mask_ratio=mask_ratio, mae_loss_coef=0.1)
    loader = DataLoader(SyntheticLatentDataset(batch, res, 4, 1000), batch, num_workers=4)
    host = next(iter(loader))
    batch_dev = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch_dev, gen)
    flag = "" if use_flash is None else f", use_flash={use_flash}"
    _, busy_ms = profile_device(tag, lambda: step(state, batch_dev, gen), reps,
                                f"one train step (DiT-XL/2 @{res * 8}, batch {batch}, mask "
                                f"{mask_ratio}, {'fp32' if fp32 else 'bf16'}{flag})")
    log(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1024 ** 3:.2f} GiB")
    del model, opt, state, step
    free_device_memory()
    return busy_ms


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


def phase_overfit_gate(proc: subprocess.Popen) -> dict:
    """tools/torch_overfit_gate.py at its defaults on the card (2000 fp32
    steps of the tiny DiT-S/2, 18-step sampler, 8 classes), in the
    ``start_worker`` process ``proc`` (beside the data-parallel phases and
    [validate-port]); fails unless the verdict passes. Its launches: per step 4
    encoder + 2 decoder attention calls forward and backward and one
    update; per class 35 evaluations of 6 attention calls."""
    got = finish_worker(proc)
    verdict, seconds, launches = got["verdict"], got["seconds"], got["launches"]
    log(f"[overfit-gate] {json.dumps(verdict)}; {seconds:.1f} s")
    if not verdict["passed"]:
        raise AssertionError(f"overfit-gate: {verdict}")
    steps, blocks, classes, evals = 2000, 4 + 2, 8, 2 * 18 - 1
    expect_launches("overfit-gate", launches, packed_fwd=steps * blocks + classes * evals * blocks,
                    packed_bwd=steps * blocks, adam=steps)
    return dict(verdict=verdict, seconds=seconds, launches=launches)


def write_validate_checkpoint(ckpt: str) -> None:
    """[weights]' tensors as a reference .pt whose ``ema`` is those tensors
    and whose ``model`` differs from them by VALIDATE_DELTA."""
    from maskdit_tpu_torch.utils.ckpt import load_reference_checkpoint

    ema = load_reference_checkpoint(ckpt)
    raw = {k: v + VALIDATE_DELTA for k, v in ema.items()}
    torch.save({"model": raw, "ema": ema, "args": {}}, VALIDATE_CKPT)


def phase_validate_port(ckpt: str, vae_path: str) -> dict:
    """tools/torch_validate_port.py (its ``main``) on VALIDATE_CKPT at 256 px
    with ``--sample`` and [vae]'s file, then at 512 px: both state dicts
    wholly consumed and filling every parameter, no tensor non-finite, the
    EMA delta VALIDATE_DELTA (> 0), every sigma row finite and within
    MODEL_REL_BOUND[bf16] of the same table on the plain attention, 8 PNGs
    read back; #1 launched VALIDATE_SIGMAS x 36 times for the table and (2
    x STEPS - 1) x 36 for the sample at 256 px, #3 VALIDATE_SIGMAS x 36 at
    512 px, nothing else."""
    from tools.torch_validate_port import main as validate, sigma_table

    t0 = time.perf_counter()
    write_validate_checkpoint(ckpt)
    log(f"[validate-port] wrote a reference .pt of [weights]' tensors, model = ema + "
        f"{VALIDATE_DELTA} ({os.path.getsize(VALIDATE_CKPT) / 1e9:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    layers = DEPTH + DECODER_DEPTH
    out, launches = {}, {name: 0 for name in kernel_counters()}
    bnd = MODEL_REL_BOUND[torch.bfloat16]
    for res, counter in ((32, "packed_fwd"), (64, "big_fwd")):
        outdir = os.path.join(SCRATCH, f"port-check-{res * 8}")
        argv = ["--ckpt_path", VALIDATE_CKPT, "--image_size", str(res), "--outdir", outdir,
                "--device", "cuda"]
        if res == 32:
            argv += ["--sample", "--vae_path", vae_path]
        free_device_memory()
        reset_launches()
        t0 = time.perf_counter()
        got = validate(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        run = read_launches()
        evals = VALIDATE_SIGMAS + (2 * STEPS - 1 if res == 32 else 0)
        expect_launches(f"validate-port-{res * 8}", run, **{counter: evals * layers})
        for name, count in run.items():
            launches[name] += count
        model, (x, y) = got.pop("model"), got.pop("inputs")
        with plain_attention():
            plain = sigma_table(model, x, y)
        del model
        table = np.array([(r["norm_ratio"], r["resid"]) for r in got["table"]])
        ref = np.array([(r["norm_ratio"], r["resid"]) for r in plain])
        rel = (np.abs(table - ref).max(axis=0) / np.abs(ref).max(axis=0)).tolist()
        cover = got["coverage"]
        rows = [(r["sigma"], round(r["norm_ratio"], 4), round(r["resid"], 2))
                for r in got["table"]]
        log(f"[validate-port] {res * 8} px: coverage "
            f"{ {k: (c['n_src'], c['n_dst']) for k, c in cover.items()} }, EMA delta "
            f"{got['ema_delta']:.3e}; sigma -> (||D||/||x||, ||D - c_skip x||) {rows}"
            f"; kernel vs plain max rel err per column {[f'{v:.3e}' for v in rel]} (bound "
            f"{bnd:.0e}); {seconds:.1f} s")
        if any(c["non_finite"] or c["unused"] or c["unfilled"] or c["n_src"] != c["n_dst"]
               for c in cover.values()):
            raise AssertionError(f"validate-port {res * 8}: coverage {cover}")
        if not (np.isfinite(table).all() and max(rel) <= bnd
                and abs(got["ema_delta"] - VALIDATE_DELTA) < VALIDATE_DELTA / 2):
            raise AssertionError(f"validate-port {res * 8}: table {got['table']}, plain "
                                 f"{plain}, delta {got['ema_delta']}")
        if res == 32:
            read_pngs(outdir, VALIDATE_SAMPLES, 256)
        out[res * 8] = dict(table=got["table"], rel=rel, seconds=seconds,
                            ema_delta=got["ema_delta"])
    os.remove(VALIDATE_CKPT)
    out["launches"] = launches
    return out


BACKGROUND: list = []  # start_process's processes, stopped by stop_background


def start_process(tag: str, argv: list, **env) -> subprocess.Popen:
    """``argv`` in a process group of its own, from the repository's root,
    beside whatever runs here; its output goes to a log for
    ``finish_process``. Scripts see DEVICE=cuda and this interpreter as
    PYTHON."""
    log_path = os.path.join(SCRATCH, f"{tag}.log")
    os.makedirs(SCRATCH, exist_ok=True)
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            argv, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
            env={**os.environ, "DEVICE": "cuda", "PYTHON": sys.executable, **env})
    proc.tag, proc.log_path, proc.t0 = tag, log_path, time.perf_counter()

    def ended() -> None:  # the process's own end, whenever it is collected
        proc.wait()
        proc.t1 = time.perf_counter()

    proc.watch = threading.Thread(target=ended, daemon=True)
    proc.watch.start()
    BACKGROUND.append(proc)
    return proc


def stop_background() -> None:
    """Kill the process group of every ``start_process`` process still
    running (a phase failed before waiting for it)."""
    for proc in BACKGROUND:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def finish_process(proc: subprocess.Popen) -> tuple[int, str, float]:
    """Wait for a ``start_process`` process (killed past WORKER_TIMEOUT);
    logs its output; returns its exit code, output and seconds from its
    start to its end."""
    try:
        rc = proc.wait(timeout=WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        raise
    proc.watch.join()
    seconds = proc.t1 - proc.t0
    with open(proc.log_path) as f:
        text = f.read()
    for line in text.splitlines():
        log(f"[{proc.tag}:out] {line}")
    return rc, text, seconds


def start_worker(tag: str, *args: str) -> subprocess.Popen:
    """This script's ``worker_alone`` ``tag`` in a process of its own."""
    result = os.path.join(SCRATCH, f"{tag}{''.join('-' + a for a in args)}.json")
    if os.path.exists(result):
        os.remove(result)
    proc = start_process(os.path.basename(result)[:-5],
                         [sys.executable, os.path.abspath(__file__), "--worker-alone", tag,
                          result, *args])
    proc.result = result
    return proc


def finish_worker(proc: subprocess.Popen) -> dict:
    """A ``start_worker`` process's result: exit 0, then its JSON."""
    rc, text, _ = finish_process(proc)
    if rc != 0:
        raise AssertionError(f"{proc.tag}: the worker failed ({rc}):\n{text[-3000:]}")
    with open(proc.result) as f:
        return json.load(f)


def worker_alone(tag: str, result: str, *args: str) -> None:
    """A phase run beside others in a process of its own (no process
    group), with the launch counts read there and written with its result:
    ``mu-curve VARIANT`` (tools/torch_mu_dtype_curve.py's ``run`` at
    MU_CURVE_STEPS steps; ``fp32`` for the fp32 run) or ``overfit-gate``
    (tools/torch_overfit_gate.py's ``run_gate`` at its defaults). TF32 is
    off, as in the main process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launches()
    t0 = time.perf_counter()
    if tag == "mu-curve":
        from tools.torch_mu_dtype_curve import VARIANTS, run

        out = dict(losses=run(MU_CURVE_STEPS, device="cuda", **VARIANTS.get(args[0], {})))
    elif tag == "overfit-gate":
        from tools.torch_overfit_gate import run_gate

        out = dict(verdict=run_gate(out=os.path.join(SCRATCH, "overfit-gate"), device="cuda"))
    else:
        raise SystemExit(f"unknown worker {tag}")
    torch.cuda.synchronize()
    out.update(launches=read_launches(), seconds=time.perf_counter() - t0)
    with open(result, "w") as f:
        json.dump(out, f)


def start_scripts() -> dict:
    """[fid-gate-dry] scripts/torch_fid_parity_gate.sh --dry-wire and
    [smoke-pipeline] scripts/torch_smoke_pipeline.sh, started on the card in
    processes of their own (mostly their stages' start-up), to run beside
    the phases that follow until ``finish_scripts``."""
    pipe_root = os.path.join(SCRATCH, "pipe")
    shutil.rmtree(pipe_root, ignore_errors=True)
    return {
        "fid-gate-dry": start_process(
            "fid-gate-dry", ["bash", "scripts/torch_fid_parity_gate.sh", "--dry-wire"],
            FID_GATE_TMP=os.path.join(SCRATCH, "fid-gate")),
        "smoke-pipeline": start_process(
            "smoke-pipeline", ["bash", "scripts/torch_smoke_pipeline.sh"], PIPE_ROOT=pipe_root),
    }


def finish_scripts(procs: dict) -> dict:
    """Each script exited 0 with its closing line (``DRY WIRING OK``,
    ``PIPELINE COMPLETE``) and a finite FID; the pipeline's 8 PNGs (64 px)
    read back."""
    out = {}
    for tag, closing in (("fid-gate-dry", "DRY WIRING OK"),
                         ("smoke-pipeline", "=== PIPELINE COMPLETE ===")):
        rc, text, seconds = finish_process(procs[tag])
        fids = [float(v) for v in re.findall(r"FID: ([-+0-9.eEnaif]+)", text)]
        log(f"[{tag}] exit {rc} in {seconds:.1f} s; FID {fids}")
        if rc != 0 or closing not in text or not fids or not np.isfinite(fids[-1]):
            raise AssertionError(f"{tag}: exit {rc}, FID {fids}:\n{text[-3000:]}")
        out[tag] = dict(seconds=seconds, fid=fids[-1])
    read_pngs(os.path.join(SCRATCH, "pipe", "samples"), 8, 64)
    return out


def start_mesh() -> subprocess.Popen:
    """[parity-mesh] and [train-mesh]: MESH_RANKS ranks of this script's
    ``--worker mesh`` under torch.distributed.run, in a process group of
    their own beside the phases that follow, until ``phase_mesh``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    result = os.path.join(SCRATCH, "mesh.json")
    if os.path.exists(result):
        os.remove(result)
    proc = start_process("mesh", [
        sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(MESH_RANKS),
        "--master_addr", "127.0.0.1", "--master_port", str(port), os.path.abspath(__file__),
        "--worker", "mesh", result])
    proc.result = result
    return proc


def check_parity_mesh(out: dict) -> dict:
    """[parity-mesh]'s cases from ``parity_mesh``'s result, each within its
    bounds (see ``phase_mesh``); the launches of their checked steps, summed
    over the ranks."""
    log(f"[parity-mesh] gloo on CUDA tensors (torch {torch.__version__}): {out['gloo_cuda']}")
    parity_launches = {name: 0 for name in kernel_counters()}
    for name, res, n, shape, dtype, nu, remat, use_flash in MESH_PARITY:
        got = out["parity"][name]
        bnd = TRAIN_PARITY_BOUND[dtype]
        route = "flash" if use_flash else "big" if res == 64 else "packed"
        # a recomputed attention forward per block under remat; the flash
        # route's own checkpoint recomputes it too
        again = 2 if remat or use_flash else 1
        per_rank = {f"{route}_fwd": again * DDP_ATTN_PER_STEP, f"{route}_bwd": DDP_ATTN_PER_STEP,
                    "adam": ADAM_PER_STEP}
        for rank, launches in enumerate(got["launches"]):
            expect_launches(f"parity-mesh {name} rank {rank}", launches, **per_rank)
            for k, v in launches.items():
                parity_launches[k] += v
        held, reckoned = got["held_bytes"], got["reckoned_bytes"]
        gib = lambda key: [round(b / 2**30, 2) for b in got[key]]
        log(f"[parity-mesh] {name}: {MESH_RANKS} ranks on {shape}, DiT-XL/2 @{res * 8} at "
            f"{DDP_DEPTH} encoder blocks, batch {n}, {dtype_name(dtype)}, nu "
            f"{nu or 'float32'}, remat {remat or 'none'}"
            f"{', use_flash' if use_flash else ''}, vs one process: loss rel err "
            f"{got['loss']:.3e} (bound "
            f"{bnd['loss']:.0e}), max per-tensor gradient rel-norm err {got['grad']:.3e} (bound "
            f"{bnd['grad']:.0e}, worst {got['worst_grad']}), p/ema/mu"
            f"{'' if nu else '/nu'} {got['state']:.3e} (bound {bnd['state']:.0e}), nu "
            f"{got['nu']:.3e}" + (f", within one bf16 ulp {got['nu_within_ulp']}, equal "
                                  f"{got['nu_equal']}" if nu and dtype == torch.float32 else "")
            + (f"; vs {MESH_SAME_AS[name]} (no remat) bit for bit {got['same_as']}"
               if name in MESH_SAME_AS else "")
            + f"; state on the card per rank {[round(b / 2**20, 1) for b in held]} MiB vs the "
            f"rules' {[round(b / 2**20, 1) for b in reckoned]} MiB (unsharded "
            f"{got['full_bytes'] / 2**20:.1f} MiB); {got['segments']} segments; launches per "
            f"rank {' '.join(f'{KERNEL_NUMBERS[k]} {v}' for k, v in got['launches'][0].items() if v)}"
            f"; per rank, above the step's start: peak {gib('peak')} GiB (up to the "
            f"gradient's reduction {gib('peak_to_reduction')}), at the backward's first gather "
            f"{gib('backward_start')} and at its end {gib('backward_end')} GiB (unit buffers "
            f"gathered then {gib('units_gathered')} GiB); the units' parameter and gradient "
            f"buffers alive at once at most {gib('units_alive')} GiB (bound: the root and the "
            f"two largest blocks, twice, {gib('units_bound')} GiB); the fp32 reduction's "
            f"staging per unit at most {gib('staging')} GiB (reckoned); the step "
            f"{[round(x, 1) for x in got['ms']]} ms ({MESH_RANKS} gloo ranks sharing the card, "
            f"beside the group's phases); {got['seconds']:.1f} s with its one-process step")
        ok = (got["loss"] <= bnd["loss"] and got["grad"] <= bnd["grad"]
              and got["state"] <= bnd["state"] and got["same_as"]
              and all(abs(h - r) <= 0.02 * r for h, r in zip(held, reckoned))
              and all(a <= b for a, b in zip(got["units_alive"], got["units_bound"])))
        if nu and dtype == torch.float32:
            ok = ok and got["nu_within_ulp"]
        elif nu:
            ok = ok and got["nu"] <= bnd["state"]
        if not ok:
            raise AssertionError(f"parity-mesh {name}: {got}")
    return parity_launches


def phase_mesh(proc: subprocess.Popen) -> dict:
    """The mesh launch's result: each [parity-mesh] case within its bounds
    (TRAIN_PARITY_BOUND of its model dtype; a bf16 nu of an fp32 model
    within one bf16 ulp per element) with #1 / #2 (or #3 / #4 at 512 px, #5
    / #6 with use_flash) at 8 heads once per block (the forward twice under
    remat or use_flash) and #7 once on every rank, a case of MESH_SAME_AS
    bit for bit with its case without remat, and every rank's state within
    2% of its shards' bytes by the rules and its units' buffers within
    ``unit_bytes``' bound at every event; [train-mesh]'s finite
    losses and launches on every rank, then its last checkpoint resumed in
    this process without a group: the parameters equal the run's, gathered
    from the shards, bit for bit."""
    from maskdit_tpu_torch.train.cli import apply_overrides
    from maskdit_tpu_torch.train.trainer import Trainer

    out = finish_worker(proc)
    parity_launches = check_parity_mesh(out)
    train = out["train"]
    expect_launches("train-mesh", {k: sum(c[k] for c in train["launches"])
                                   for k in train["launches"][0]},
                    packed_fwd=MESH_RANKS * DDP_ATTN_PER_STEP * MESH_TRAIN_STEPS,
                    packed_bwd=MESH_RANKS * DDP_ATTN_PER_STEP * MESH_TRAIN_STEPS,
                    adam=MESH_RANKS * MESH_TRAIN_STEPS)
    if len(train["losses"]) != MESH_TRAIN_STEPS or not np.all(np.isfinite(train["losses"])):
        raise AssertionError(f"train-mesh: {train}")
    config = apply_overrides(json.loads(json.dumps(TRAIN_CONFIG)), [
        f"train.batchsize={MESH_TRAIN_BATCH * MESH_RANKS}"])
    with xl_depth(DDP_DEPTH):
        trainer = Trainer(config, results_dir=os.path.join(SCRATCH, "train-mesh"),
                          num_workers=1, device="cuda")
    digest = params_digest(trainer.state.params)
    same = trainer.start_step == MESH_TRAIN_STEPS and digest == train["digest"]
    log(f"[train-mesh] --mesh {MESH_TRAIN}, {MESH_RANKS} gloo ranks on the card, DiT-XL/2 @256 at "
        f"{DDP_DEPTH} encoder blocks, global batch {MESH_TRAIN_BATCH * MESH_RANKS}: losses "
        f"{[round(x, 4) for x in train['losses']]}; {train['ms_per_step']:.1f} ms/step (gloo "
        f"through the host; the CLI run with its checkpoint {out['train_seconds']:.1f} s); "
        f"peak per rank {[round(x, 2) for x in train['peak_gib']]} GiB; "
        f"resumed in one process without a group at step {trainer.start_step}: parameters "
        f"{digest[:16]} vs the mesh's gathered {train['digest'][:16]}, bit for bit {same}")
    del trainer
    free_device_memory()
    if not same:
        raise AssertionError(f"train-mesh: the one-process resume differs: {digest} vs "
                             f"{train['digest']}")
    shutil.rmtree(os.path.join(SCRATCH, "train-mesh"), ignore_errors=True)
    out["launches"] = {k: sum(c[k] for c in train["launches"]) + parity_launches[k]
                       for k in train["launches"][0]}
    return out


def phase_mu_curve(procs: dict) -> dict:
    """tools/torch_mu_dtype_curve.py's ``run`` (in ``start_worker``
    processes, one per curve, beside the data-parallel phases and
    [validate-port]) and ``report_of`` (what
    its ``main`` prints for one variant) for mu, nu and munu at
    MU_CURVE_STEPS steps against one fp32 run (``main`` would repeat it per
    variant): the JAX tool's report keys; every loss finite; #7 once per step
    and the whole-row kernels once per block and step in each run. The guard
    tail20_gap <= MU_CURVE_GUARD x tail20_mean_fp32 catches a divergence
    only; it is not a parity bound."""
    from tools.torch_mu_dtype_curve import report_of

    out, launches, curves = {}, {name: 0 for name in kernel_counters()}, {}
    for variant in ("fp32", "mu", "nu", "munu"):
        got = finish_worker(procs[variant])
        expect_launches(f"mu-curve-{variant}", got["launches"],
                        packed_fwd=MU_CURVE_STEPS * MU_CURVE_BLOCKS,
                        packed_bwd=MU_CURVE_STEPS * MU_CURVE_BLOCKS, adam=MU_CURVE_STEPS)
        for name, count in got["launches"].items():
            launches[name] += count
        curves[variant] = got["losses"]
        if len(curves[variant]) != MU_CURVE_STEPS or not np.isfinite(curves[variant]).all():
            raise AssertionError(f"mu-curve {variant}: losses {curves[variant]}")
        if variant == "fp32":
            log(f"[mu-curve] fp32: {MU_CURVE_STEPS} steps in {got['seconds']:.1f} s")
            continue
        report = report_of(variant, MU_CURVE_STEPS, curves["fp32"], curves[variant])
        keys = ["variant", "steps", "final_loss_fp32", f"final_loss_{variant}",
                "tail20_mean_fp32", f"tail20_mean_{variant}", "tail20_gap", "max_step_gap",
                "mean_step_gap"]
        log(f"[mu-curve] {variant}: {json.dumps(report)}; {got['seconds']:.1f} s")
        if (list(report) != keys
                or report["tail20_gap"] > MU_CURVE_GUARD * report["tail20_mean_fp32"]):
            raise AssertionError(f"mu-curve {variant}: {report}")
        out[variant] = dict(max_step_gap=report["max_step_gap"],
                            tail20_gap=report["tail20_gap"], seconds=got["seconds"])
    out["launches"] = launches
    return out


def phase_trace(profile_busy_ms: float) -> dict:
    """tools/torch_trace_capture.py (its ``main``) in train mode at
    [train-profile]'s batch and in sample mode (TRACE_SAMPLE_STEPS steps,
    batch SEEDS), each trace read by tools/torch_trace_report.py: the train
    report names #1, #2 and #7 among its categories and the sample report
    #1; the train step's device ms within TRACE_BUSY_TOLERANCE of
    [train-profile]'s busy ms; ``device_memory_stats()['mem_peak_gib']`` the
    allocator's peak in GiB. Launches: 1 + 2 + 5 + TRACE_STEPS train steps
    (36 + 36 and one update each) and 3 sampler runs."""
    from tools import torch_trace_capture as capture, torch_trace_report as report_tool
    from maskdit_tpu_torch.utils.profiling import device_memory_stats

    out, launches = {}, {name: 0 for name in kernel_counters()}
    layers = DEPTH + DECODER_DEPTH
    plans = {
        "train": ({"PROBE_BATCH": str(TRAIN_BATCH), "N_STEPS": str(TRACE_STEPS)}, TRACE_STEPS,
                  dict(packed_fwd=(8 + TRACE_STEPS) * layers,
                       packed_bwd=(8 + TRACE_STEPS) * layers, adam=8 + TRACE_STEPS),
                  ("#1 packed_attention_fwd", "#2 packed_attention_bwd", "#7 fused_adam_ema")),
        "sample": ({"PROBE_MODE": "sample", "PROBE_STEPS": str(TRACE_SAMPLE_STEPS),
                    "PROBE_BATCH": str(SEEDS), "N_STEPS": str(TRACE_STEPS)}, 1,
                   dict(packed_fwd=3 * (2 * TRACE_SAMPLE_STEPS - 1) * layers),
                   ("#1 packed_attention_fwd",)),
    }
    for mode, (env, runs, expected, names) in plans.items():
        trace_dir = os.path.join(SCRATCH, f"trace-{mode}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        free_device_memory()
        reset_launches()
        t0 = time.perf_counter()
        got = capture.main([trace_dir, "--device", "cuda"], env=env)
        seconds = time.perf_counter() - t0
        run = read_launches()
        expect_launches(f"trace-{mode}", run, **expected)
        for name, count in run.items():
            launches[name] += count
        mem = device_memory_stats()
        peak = torch.cuda.max_memory_allocated() / 1024 ** 3
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rep = report_tool.main([trace_dir, str(runs)])
        for line in printed.getvalue().splitlines()[:40]:
            log(f"[trace-{mode}:report] {line}")
        cats = {k: round(v, 3) for k, v in sorted(rep["categories"].items(), key=lambda kv: -kv[1])}
        log(f"[trace-{mode}] first {got['first_s']:.1f} s, steady {got['steady_ms']:.1f} ms; "
            f"device {rep['ms_per_step']:.3f} ms per {'step' if mode == 'train' else 'run'} in "
            f"{rep['events']} events; by category {cats}; memory {mem}, allocator peak "
            f"{peak:.4f} GiB; {seconds:.1f} s")
        missing = [n for n in names if n not in rep["categories"]]
        if missing or abs(mem.get("mem_peak_gib", -1) - peak) > 1e-9:
            raise AssertionError(f"trace-{mode}: categories {cats} lack {missing}; memory {mem} "
                                 f"vs {peak}")
        out[mode] = dict(ms=rep["ms_per_step"], categories=rep["categories"], seconds=seconds,
                         steady_ms=got["steady_ms"], mem=mem)
    gap = abs(out["train"]["ms"] - profile_busy_ms) / profile_busy_ms
    log(f"[trace] train step device {out['train']['ms']:.3f} ms against [train-profile]'s busy "
        f"{profile_busy_ms:.3f} ms: {gap:.3f} apart (bound {TRACE_BUSY_TOLERANCE})")
    if gap > TRACE_BUSY_TOLERANCE:
        raise AssertionError(f"trace: {out['train']['ms']} vs {profile_busy_ms}")
    out["launches"] = launches
    return out


def phase_attn_bench() -> dict:
    """tools/torch_attn_bench.py (its ``bench``) with xla, batched and flash
    at its SHAPES: every row timed (finite) or refused with the kernel's
    message; a refusal only where the JAX window sends the shape elsewhere
    (``flash_batched.jax_window`` false, batched rows only); the whole-row
    (#1 / #2) and flash (#5 / #6) launches of the rows timed: per row
    ATTN_BENCH_CALLS forward calls, and as many forward + backward."""
    from tools.torch_attn_bench import IMPLS, SHAPES, bench
    from maskdit_tpu_torch.ops.flash_batched import jax_window

    free_device_memory()
    reset_launches()
    t0 = time.perf_counter()
    rows = bench(list(IMPLS), torch.device("cuda"))
    seconds = time.perf_counter() - t0
    launches = read_launches()
    shapes = dict(SHAPES)
    counters = {"batched": ("packed_fwd", "packed_bwd"), "flash": ("flash_fwd", "flash_bwd")}
    want = {}
    for r in rows:
        if "refused" in r:
            n, h, l, hd = shapes[r["shape"]]
            if r["impl"] != "batched" or jax_window(h, l, hd):
                raise AssertionError(f"attn-bench: {r}")
        elif not np.isfinite([r["fwd_ms"], r["fwd_bwd_ms"]]).all():
            raise AssertionError(f"attn-bench: {r}")
        elif r["impl"] in counters:
            fwd, bwd = counters[r["impl"]]
            want[fwd] = want.get(fwd, 0) + 2 * ATTN_BENCH_CALLS
            want[bwd] = want.get(bwd, 0) + ATTN_BENCH_CALLS
    expect_launches("attn-bench", launches, **want)
    log(f"[attn-bench] {len(rows)} rows, refused "
        f"{[(r['shape'], r['impl']) for r in rows if 'refused' in r]}; {seconds:.1f} s")
    return dict(rows=rows, launches=launches, seconds=seconds)


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
    fp32_k = phase_fp32_kernels()
    mark("kernel rows")
    try:
        ckpt = phase_weights()
        main_path = phase_main(ckpt)
        parity = phase_model_parity(ckpt)
        main_512 = phase_main_512(ckpt)
        parity_512 = phase_model_parity(ckpt, "parity-512", 64, SEEDS_512, ("kernel",))
        mark("sampling")
        aot = phase_aot(ckpt)
        mark("aot")
        vae = phase_vae()
        mark("vae")
        extract = phase_extract(vae["path"])
        mark("extract")
        main_png = phase_main_png(ckpt, vae["path"])
        mark("main-png")
        evals = phase_eval(ckpt, vae["path"], main_png["outdir"])
        mark("eval")
        train = phase_train(vae["path"], evals["stats"])
        with xl_depth(FLASH_DEPTH):  # a check: 4 encoder blocks since [remat] came
            parity_train = phase_parity_train()
        profile_busy = phase_train_profile()
        mark("train (with train-eval)")
        remat = phase_remat(smi)
        mark("remat")
        with xl_depth(FLASH_DEPTH):
            train_options = phase_train_options(train)
            train_staged = phase_train_staged(train)
        train_staged["update"] = profile_staged_update(adam)
        mark("train-options, train-staged")
        # the script twins, the overfit gate and the mu-curve's four runs, in
        # processes of their own, beside phases whose results are checks
        scripts, gate = start_scripts(), start_worker("overfit-gate")
        curves = {v: start_worker("mu-curve", v) for v in ("fp32", "mu", "nu", "munu")}
        mesh_proc = start_mesh()
        with xl_depth(FLASH_DEPTH):  # checks: 4 encoder blocks since [remat] came
            parity_options = phase_parity_train_options()
            parity_staged = phase_parity_train_staged()
        parity_ddp = phase_parity_ddp()
        train_ddp = phase_train_ddp()
        train_ddp_nccl = phase_train_ddp_nccl()
        validate = phase_validate_port(ckpt, vae["path"])
        mu_curve = phase_mu_curve(curves)
        scripts, gate = finish_scripts(scripts), phase_overfit_gate(gate)
        mesh = phase_mesh(mesh_proc)
        mark("parity of the options and the staged step, data parallel, validate-port (beside "
             "them the script twins, the overfit gate, mu-curve, the mesh)")
        train_512 = run_train("train-512", TRAIN_CONFIG_512, 64, dict(
            big_fwd=ATTN_PER_STEP, big_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP))
        with xl_depth(FLASH_DEPTH):
            parity_train_512 = phase_parity_train("parity-train-512", 64, PARITY_BATCH_512)
        phase_train_profile("train-profile-512", 64, TRAIN_BATCH_512, 2)
        mark("train-512")
        with xl_depth(FLASH_DEPTH):
            parity_flash = phase_flash_parity(ckpt)
            # the checkpoint recomputes each layer's forward in the backward
            train_flash = run_train("train-flash", TRAIN_CONFIG_512, 64, dict(
                flash_fwd=2 * FLASH_ATTN_PER_STEP, flash_bwd=FLASH_ATTN_PER_STEP,
                adam=ADAM_PER_STEP),
                ("model.use_flash=true", "data.streaming=true",
                 f"train.max_num_steps={TRAIN_STEPS_FLASH}"))
            parity_train_flash = phase_parity_train("parity-train-flash", 64, PARITY_BATCH_512,
                                                    use_flash=True)
            phase_train_profile("train-profile-flash", 64, TRAIN_BATCH_512, 2, use_flash=True)
        mark("train-flash")
        finetune = {"256": phase_finetune("train-finetune256", "256-latent-const"),
                    "cos": phase_finetune("train-finetune-cos", "256-latent-cos"),
                    "512": phase_finetune("train-finetune512", "512-latent"),
                    "512-flash": phase_finetune("train-finetune512-flash", "512-latent",
                                                FINETUNE_FLASH_OVERRIDES)}
        parity_finetune = phase_parity_train_finetune()
        with xl_depth(FLASH_DEPTH):
            parity_finetune["flash"] = phase_parity_train_finetune_flash()
        phase_train_profile("train-profile-finetune256", 32, FINETUNE_BATCH, 1, fp32=True,
                            mask_ratio=0.0)
        phase_train_profile("train-profile-finetune512", 64, FINETUNE_BATCH_512, 1, fp32=True,
                            mask_ratio=0.0)
        phase_train_profile("train-profile-finetune512-flash", 64, FINETUNE_BATCH_512, 1,
                            use_flash=True, fp32=True, mask_ratio=0.0)
        mark("finetune")
        with xl_depth(FLASH_DEPTH):
            sample_cls = phase_sample_cls(ckpt)
            train_cls = phase_train_cls_feat()
            parity_cls = phase_parity_cls()
        mark("model corners")
        traced = phase_trace(profile_busy)
        attn_bench = phase_attn_bench()
        mark("trace, attn-bench")
    finally:
        stop_background()
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[summary] {smi}: sampling 256 {main_path['images_per_s']:.3f} images/s (cold), "
        f"warm {parity['sampling']['kernel']}; sampling 512 {main_512['images_per_s']:.3f} "
        f"(cold), warm {parity_512['sampling']['kernel']}; model rel err 256 bf16 "
        f"{parity['bfloat16']:.3e}, fp32 {parity['float32']:.3e}, 512 bf16 "
        f"{parity_512['bfloat16']:.3e}, fp32 {parity_512['float32']:.3e}; training 256 "
        f"{train['images_per_s']:.2f} images/s, MFU {train['mfu']:.4f}, peak "
        f"{train['peak_gib']:.2f} GiB; remat (batch {TRAIN_BATCH}) " + ", ".join(
            f"{k} {v['ms']:.1f} ms/step, peak {v['peak_gib']:.2f} GiB, "
            + ("bit for bit" if v["exact"] else f"grad err {v['err']['grad']:.3e}")
            for k, v in remat.items() if k in REMAT_POLICIES) +
        f", full at batch {remat['big']['batch']} {remat['big']['ms']:.1f} ms/step, peak "
        f"{remat['big']['peak_gib']:.2f} GiB, loss {remat['big']['loss']:.4f}; " + "; ".join(
            f"remat {group} (batch {TRAIN_BATCH_512}) " + ", ".join(
                f"{k} {v['ms']:.1f} ms/step, peak {v['peak_gib']:.2f} GiB, "
                + ("bit for bit" if v["exact"] else f"grad err {v['err']['grad']:.3e}")
                for k, v in remat[group].items() if k in REMAT_POLICIES)
            for group in ("512", "flash")) +
        f"; training 512 {train_512['images_per_s']:.2f} images/s, "
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
        f"finetune (fp32) " + "; ".join(
            f"{k} {v['ms_per_step']:.1f} ms/step, {v['images_per_s']:.2f} images/s, MFU "
            f"{v['mfu']:.4f} ({v['mfu_fp32']:.4f} of fp32), peak {v['peak_gib']:.2f} GiB"
            for k, v in finetune.items()) + f"; parity {parity_finetune}; kernel-fp32 " + ", ".join(
            f"{k} {v['route']} fwd {v['fwd']['ms']:.3f} / bwd {v['bwd']['ms']:.3f} ms"
            for k, v in fp32_k["rows"].items()) +
        f"; model corners: sample-cls {sample_cls['images_per_s']:.3f} images/s (cold), rel err "
        f"bf16 {sample_cls['bfloat16']:.3e}, fp32 {sample_cls['float32']:.3e}; train-cls-feat "
        f"{train_cls['images_per_s']:.2f} images/s, {train_cls['ms_per_step']:.1f} ms/step; "
        f"parity-cls {parity_cls}; train-staged {train_staged['ms_per_step']:.1f} ms/step, "
        f"{train_staged['images_per_s']:.2f} images/s, peak {train_staged['peak_gib']:.2f} GiB, "
        f"update {train_staged['update']}, with bf16 mu and nu "
        f"{train_staged['nu']['ms_per_step']:.1f} ms/step; parity-train-staged {parity_staged}; "
        f"aot " + "; ".join(
            f"{k} export {v['export_s']:.1f} s, {v['mb']:.1f} MB, reload {v['reload_s']:.1f} s, "
            f"rel err {v['rel']:.3e} (bit for bit {v['exact']}), images/s exported "
            f"{[round(x, 3) for x in v['images_per_s']]} live "
            f"{[round(x, 3) for x in v['live_images_per_s']]}"
            for k, v in aot.items() if k != "launches") +
        f"; tool twins: validate-port sigma rows kernel vs plain "
        f"{ {k: [round(x, 6) for x in v['rel']] for k, v in validate.items() if k != 'launches'} }"
        f", fid-gate-dry FID {scripts['fid-gate-dry']['fid']:.4f} in "
        f"{scripts['fid-gate-dry']['seconds']:.1f} s, smoke-pipeline FID "
        f"{scripts['smoke-pipeline']['fid']:.4f} in {scripts['smoke-pipeline']['seconds']:.1f} s, "
        f"mu-curve " + ", ".join(
            f"{k} max_step_gap {v['max_step_gap']:.3e} tail20_gap {v['tail20_gap']:.3e}"
            for k, v in mu_curve.items() if k != "launches") +
        f", trace train {traced['train']['ms']:.3f} ms/step (train-profile {profile_busy:.3f}), "
        f"sample {traced['sample']['ms']:.3f} ms/run, attn-bench " + ", ".join(
            f"{r['shape']} {r['impl']} "
            + (f"{r['fwd_ms']:.3f} / {r['fwd_bwd_ms']:.3f}" if "fwd_ms" in r else "refused")
            for r in attn_bench["rows"]) +
        f" ms; mesh: parity " + ", ".join(
            f"{k} loss {v['loss']:.3e} grad {v['grad']:.3e} state {v['state']:.3e} nu "
            f"{v['nu']:.3e}" for k, v in mesh["parity"].items()) +
        f", gloo on CUDA tensors {mesh['gloo_cuda']}, train-mesh "
        f"{mesh['train']['ms_per_step']:.1f} ms/step (gloo through the host), peak per rank "
        f"{[round(x, 2) for x in mesh['train']['peak_gib']]} GiB; fused adam on a shard "
        f"{adam['shard']['ms']:.4f} ms ({adam['shard']['numel']} params, bound "
        f"{adam['shard']['bound_ms']:.4f}); chip_smoke.py took "
        f"{time.perf_counter() - t_start:.1f} s")
    bf16 = lambda rows, names: max(rows[(n, "bfloat16")]["err"] for n in names)
    paths = (main_path, train, remat, main_512, train_512, train_flash, main_png, evals, gate,
             train_options, train_ddp, train_ddp_nccl, train_ddp_nccl["alone"],
             *finetune.values(), sample_cls, train_cls, train_staged, train_staged["nu"], aot,
             validate, mu_curve, traced, attn_bench, mesh)
    count = lambda key: sum(p["launches"][key] for p in paths)
    fp32_err = lambda rows, route, d, sweep: max(
        [v["err"] for (_, dt), v in rows.items() if dt == "float32"]
        + [v[d]["err"] for v in fp32_k["rows"].values() if v["route"] == route] + [sweep]
        + [v["err"] for v in fp32_k["cls"][f"{route}_{d}"].values()])
    packed_fp32 = [fp32_err(rows, "packed", d, fp32_k["packed_sweep_err"])
                   for rows, d in ((kernels, "fwd"), (bwd, "bwd"))]
    big_fp32 = [fp32_err(big[d], "big", d, fp32_k["sweep_err"]) for d in ("fwd", "bwd")]
    flash_fp32 = {d: max([v["err"] for (_, dt), v in flash_k[d].items() if dt == "float32"]
                         + [flash_k["fp32_err"][d]]) for d in ("fwd", "bwd")}
    print(json.dumps({"kernels": [
        {**kernel_line("packed_attention_fwd", "packed_attention_fwd.cu",
                       "flash_batched.py:162", count("packed_fwd"),
                       bf16(kernels, [s[0] for s in ATTN_FWD_SHAPES + CLS_FWD_SHAPES
                                      + MESH_ATTN_SHAPES]),
                       kernels[("encoder", "bfloat16")]),
         "max_abs_err_fp32": packed_fp32[0]},
        {**kernel_line("packed_attention_bwd", "packed_attention_bwd.cu",
                       "flash_batched.py:177", count("packed_bwd"),
                       bf16(bwd, ["train_encoder", "train_decoder", "cls_train_encoder",
                                  *(m[0] for m in MESH_ATTN_SHAPES)]),
                       bwd[("train_encoder", "bfloat16")]),
         "max_abs_err_fp32": packed_fp32[1]},
        {**kernel_line("fused_adam_ema", "fused_adam_ema.cu", "fused_adam.py:109",
                       count("adam"), adam[ADAM_VARIANTS[0]]["err"], adam[ADAM_VARIANTS[0]]),
         "shard_ms": adam["shard"]["ms"], "shard_plain_ms": adam["shard"]["plain_ms"],
         "shard_bound_ms": adam["shard"]["bound_ms"]},
        {**kernel_line("packed_attention_big_fwd", "packed_attention_big_fwd.cu",
                       "flash_big.py:213", count("big_fwd"),
                       bf16(big["fwd"], [s[0] for s in BIG_FWD_SHAPES + CLS_BIG_SHAPES]),
                       big["fwd"][("sample_encoder", "bfloat16")]),
         "max_abs_err_fp32": big_fp32[0]},
        {**kernel_line("packed_attention_big_bwd", "packed_attention_big_bwd.cu",
                       "flash_big.py:234", count("big_bwd"),
                       bf16(big["bwd"], ["train_encoder", "train_decoder",
                                         "cls_unmasked_encoder"]),
                       big["bwd"][("train_encoder", "bfloat16")]),
         "max_abs_err_fp32": big_fp32[1]},
        {**kernel_line("flash_fwd", "flash_fwd.cu", "flash.py:96", count("flash_fwd"),
                       bf16(flash_k["fwd"], ["train_encoder", "train_decoder"]),
                       flash_k["fwd"][("train_encoder", "bfloat16")]),
         "max_abs_err_fp32": flash_fp32["fwd"]},
        {**kernel_line("flash_bwd", "flash_bwd.cu", "flash.py:114", count("flash_bwd"),
                       bf16(flash_k["bwd"], ["train_encoder", "train_decoder"]),
                       flash_k["bwd"][("train_encoder", "bfloat16")]),
         "max_abs_err_fp32": flash_fp32["bwd"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:3] == ["--worker", "aot-reload"]:
        worker_aot_reload(*sys.argv[3:])
    elif sys.argv[1:2] == ["--worker-alone"]:
        worker_alone(*sys.argv[2:])
    elif sys.argv[1:2] == ["--worker"]:
        worker(*sys.argv[2:])
    else:
        main()
