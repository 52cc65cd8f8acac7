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
     256-px config at its batch of 128, cut to 12 steps, on synthetic
     latents; checks finite losses, 36 + 36 attention launches and one
     fused-update launch per step, and that resuming from the checkpoint
     restores it exactly; train-step parity kernels vs plain in fp32 and
     bf16; a profile of one train step;
  7. training at 512 px: the same CLI on the released 512-px config at its
     batch of 32, cut to 8 steps, 36 + 36 blocked-attention launches and
     one fused-update launch per step; train-step parity; a profile;
  8. the ``use_flash`` path (ops/flash.py, kernels #5 and #6): both kernels
     against their plain versions at every L of their window (bf16, head
     dims 32, 64, 72), then timed at the 512-px shapes, at the edges of
     the window and at an odd head dim; one CFG denoiser evaluation at
     512 px with ``use_flash=True``, kernels vs plain; the train CLI on the
     released 512-px config with the override ``model.use_flash=true``, at
     batch 32, cut to 6 steps: 72 flash-forward launches (the checkpoint
     recomputes each layer's forward in the backward), 36 flash-backward
     and one fused-update launch per step; train-step parity kernels vs
     plain and, in fp32, flash vs the blocked kernels; a profile.

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
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")

# configs/train/imagenet256-latent.yaml as JSON (the card's machine need
# not have PyYAML), with the cuts TRAIN_CUTS lists: synthetic latents (the
# ImageNet latents are not in the repository) and 12 steps, for the
# smoke's time; the released batch of 128; logged every 2 steps so that
# the warm window leaves out the first two. tests/test_torch_trainer.py
# holds the rest equal to the YAML.
TRAIN_STEPS, TRAIN_BATCH, LOG_EVERY = 12, 128, 2
# the same for configs/train/imagenet512-latent.yaml: 8 steps at the
# released batch of 32; tests/test_torch_512.py holds it to the YAML
TRAIN_STEPS_512, TRAIN_BATCH_512 = 8, 32

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

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# bf16 on the tensor cores, fp32 outside them, and HBM3's rate. A bound is
# the larger of operations over the peak of the inputs' type and bytes
# (each input read once, each output written once) over the memory rate.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

TRAIN_CONFIG = {
    "data": {"dataset": "imagenet256-latent", "category": "synthetic", "resolution": 32,
             "num_channels": 4, "length": TRAIN_STEPS * TRAIN_BATCH},
    "model": {"precond": "edm", "model_type": "DiT-XL/2", "in_size": 32, "in_channels": 4,
              "num_classes": 1000, "use_decoder": True, "ext_feature_dim": 0,
              "pad_cls_token": False, "mask_ratio": 0.5, "mask_ratio_fn": "constant",
              "mask_ratio_min": 0, "mae_loss_coef": 0.1, "class_dropout_prob": 0.1},
    "train": {"fp32": False, "batchsize": TRAIN_BATCH, "grad_accum": 1, "amp_grads": False,
              "accum_dtype": None, "moment_dtype": None, "epochs": 2800, "lr": 0.0001,
              "lr_rampup_kimg": 0, "xflip": False, "max_num_steps": TRAIN_STEPS},
    "log": {"log_every": LOG_EVERY, "ckpt_every": 50000, "tag": "chip-smoke"},
}
TRAIN_CUTS = {"data.category": ("lmdb", "synthetic"),
              "train.max_num_steps": (2000000, TRAIN_STEPS)}
TRAIN_CONFIG_512 = {
    "data": {"dataset": "imagenet512-latent", "category": "synthetic", "resolution": 64,
             "num_channels": 4, "length": TRAIN_STEPS_512 * TRAIN_BATCH_512},
    "model": {**TRAIN_CONFIG["model"], "in_size": 64},
    "train": {**TRAIN_CONFIG["train"], "batchsize": TRAIN_BATCH_512, "epochs": 2000,
              "max_num_steps": TRAIN_STEPS_512},
    "log": {"log_every": LOG_EVERY, "ckpt_every": 50000, "tag": "chip-smoke-512"},
}
TRAIN_CUTS_512 = {"data.category": ("webdataset", "synthetic"),
                  "train.max_num_steps": (2000000, TRAIN_STEPS_512)}
# configs/test/maskdit-512.yaml's model section (what the generate CLI
# reads), as JSON; tests/test_torch_512.py holds it equal to the YAML
SAMPLE_CONFIG_512 = {"model": {
    "precond": "edm", "model_type": "DiT-XL/2", "in_size": 64, "in_channels": 4,
    "num_classes": 1000, "use_decoder": True, "ext_feature_dim": 0, "pad_cls_token": False,
    "mask_ratio": 0.5, "mae_loss_coef": 0.1, "class_dropout_prob": 0.1,
}}
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


def library_adam_ms(grads, p, e, scalars, iters: int) -> float:
    """Two PyTorch calls for the same update, as a yardstick only:
    ``torch.optim.Adam(fused=True).step()`` and one ``torch._foreach_lerp_``
    for the EMA."""
    param = torch.nn.Parameter(p.clone())
    param.grad = grads
    ema = e.clone()
    opt = torch.optim.Adam([param], lr=scalars["lr"], betas=(scalars["b1"], scalars["b2"]),
                           eps=scalars["eps"], fused=True)

    def update():
        opt.step()
        torch._foreach_lerp_([ema], [param.detach()], scalars["one_minus_decay"])

    ms = cuda_ms(update, iters)
    del param, ema, opt
    return ms


def phase_adam_kernel() -> dict:
    from maskdit_tpu_torch.ops import fused_adam

    n = xl2_numel()
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda: torch.randn(n, generator=g, device="cuda")
    grads, p, e, v = rnd(), rnd(), rnd(), rnd().abs_().mul_(1e-2)
    scalars = fused_adam.adam_scalars(1e-4, 7, 0.9, 0.999, 1e-8, 0.9999)
    out = {}
    for m_dtype in (torch.float32, torch.bfloat16):
        m = rnd().mul_(0.1).to(m_dtype)
        want = fused_adam.fused_adam_ema_reference(grads, p, m, v, e, **scalars)
        got = [t.clone() for t in (p, m, v, e)]
        before = fused_adam.fused_adam_ema.launches
        fused_adam.fused_adam_ema(grads, *got, lr=1e-4, count_inc=7)
        torch.cuda.synchronize()
        launches = fused_adam.fused_adam_ema.launches - before
        err, ok = 0.0, launches == 1
        for name, a, b in zip(("p", "m", "v", "ema"), got, want):
            diff = (a.float() - b.float()).abs()
            err = max(err, diff.max().item())
            if name == "m" and m_dtype == torch.bfloat16:
                tol = b.float().abs() * 2.0 ** -7 + ADAM_ATOL
            else:
                tol = b.float().abs() * ADAM_RTOL + ADAM_ATOL
            ok = ok and bool((diff <= tol).all())
            del diff, tol
        dt = dtype_name(m_dtype)
        ms = cuda_ms(lambda: fused_adam.fused_adam_ema(grads, *got, lr=1e-4, count_inc=7), 10)
        plain_ms = cuda_ms(lambda: fused_adam.fused_adam_ema_reference(grads, p, m, v, e, **scalars), 5)
        moved = n * (4 * 4 + 4 * 3 + 2 * m.element_size())  # reads g,p,v,e,m; writes p,v,e,m
        bound_ms, bound_by = bound(ADAM_OPS * n, moved, torch.float32)
        log(f"[kernel] fused adam over {n} params (DiT-XL/2), mu {dt}: max_abs_err {err:.3e} "
            f"(bound per element {ADAM_RTOL:.0e}|ref| + {ADAM_ATOL:.0e}); kernel {ms:.4f} ms "
            f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.3f} of it; launches per update {launches}")
        if not ok:
            raise AssertionError(f"fused_adam_ema mu {dt}: err {err}, launches {launches}")
        out[dt] = dict(err=err, ms=ms, plain_ms=plain_ms, gbps=moved / ms / 1e6,
                       bound_ms=bound_ms, bound_by=bound_by)
        del m, want, got
    free_device_memory()
    out["float32"]["library_ms"] = library_adam_ms(grads, p, e, scalars, 10)
    log(f"[kernel] fused adam, library: torch.optim.Adam(fused=True).step() + "
        f"torch._foreach_lerp_ (two calls), fp32 mu: {out['float32']['library_ms']:.4f} ms")
    del grads, p, e, v
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


def run_train(tag: str, config: dict, res: int, per_step: dict, overrides=()) -> dict:
    """The train main path through the CLI on ``config`` with the CLI
    ``overrides``, with the launch counts set to 0 before it; checks the
    losses and that each step launched the kernels ``per_step`` names that
    many times, and no other."""
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
    reset_launches()
    out = train_main(["--config", path, "--results_dir", results, "--device", "cuda",
                      "--num_workers", "4", *overrides])
    launches = read_launches()
    steps, history = out["step"], out["history"]
    config = apply_overrides(json.loads(json.dumps(config)), overrides)
    batch, max_steps = config["train"]["batchsize"], config["train"]["max_num_steps"]
    losses = [x for r in history for x in r["losses"]]
    log(f"[{tag}] {steps} steps of DiT-XL/2 @{res * 8}, batch {batch}, mask 0.5, bf16: "
        f"losses {[round(x, 4) for x in losses]}")
    if steps != max_steps or len(losses) != max_steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: {steps} steps, losses {losses}")
    expect_launches(tag, launches, **{name: n * steps for name, n in per_step.items()})
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
                mfu=util, peak_gib=peak, results=results)


def phase_train() -> dict:
    """The 256-px train main path, then resume from its checkpoint."""
    out = run_train("train", TRAIN_CONFIG, 32, dict(packed_fwd=ATTN_PER_STEP,
                                                   packed_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP))
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


def train_parity_state(dtype: torch.dtype, seed: int, res: int, batch: int, use_flash=None):
    """A DiT-XL/2 train state with random weights and a non-trivial Adam
    state (count 10, mu ~ N(0, 1e-4^2), nu ~ |N(0, 1e-7^2)|), the same for
    the same seed."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer

    torch.manual_seed(seed)
    model = build_model(dtype, res, use_flash).cuda()
    random_weights_(model)
    opt = make_optimizer(1e-4, batch)
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


def kernel_line(name: str, source: str, replaces: str, launches: int, err: float,
                row: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"maskdit_tpu_torch/ops/csrc/{source}",
            "replaces": f"maskdit_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")}


def main() -> None:
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    bwd = phase_bwd_kernels()
    adam = phase_adam_kernel()
    big = phase_big_kernels()
    flash_k = phase_flash_kernels()
    try:
        ckpt = phase_weights()
        main_path = phase_main(ckpt)
        parity = phase_model_parity(ckpt)
        main_512 = phase_main_512(ckpt)
        parity_512 = phase_model_parity(ckpt, "parity-512", 64, SEEDS_512, ("kernel",))
        train = phase_train()
        parity_train = phase_parity_train()
        phase_train_profile()
        train_512 = run_train("train-512", TRAIN_CONFIG_512, 64, dict(
            big_fwd=ATTN_PER_STEP, big_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP))
        parity_train_512 = phase_parity_train("parity-train-512", 64, PARITY_BATCH_512)
        phase_train_profile("train-profile-512", 64, TRAIN_BATCH_512, 2)
        parity_flash = phase_flash_parity(ckpt)
        # the checkpoint recomputes each layer's forward in the backward
        train_flash = run_train("train-flash", TRAIN_CONFIG_512, 64, dict(
            flash_fwd=2 * ATTN_PER_STEP, flash_bwd=ATTN_PER_STEP, adam=ADAM_PER_STEP),
            ("model.use_flash=true", f"train.max_num_steps={TRAIN_STEPS_FLASH}"))
        parity_train_flash = phase_parity_train("parity-train-flash", 64, PARITY_BATCH_512,
                                                use_flash=True)
        phase_train_profile("train-profile-flash", 64, TRAIN_BATCH_512, 2, use_flash=True)
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
        f"{parity_train_flash}; chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    bf16 = lambda rows, names: max(rows[(n, "bfloat16")]["err"] for n in names)
    paths = (main_path, train, main_512, train_512, train_flash)
    count = lambda key: sum(p["launches"][key] for p in paths)
    print(json.dumps({"kernels": [
        kernel_line("packed_attention_fwd", "packed_attention_fwd.cu", "flash_batched.py:162",
                    count("packed_fwd"), bf16(kernels, [s[0] for s in ATTN_FWD_SHAPES]),
                    kernels[("encoder", "bfloat16")]),
        kernel_line("packed_attention_bwd", "packed_attention_bwd.cu", "flash_batched.py:177",
                    count("packed_bwd"), bf16(bwd, ["train_encoder", "train_decoder"]),
                    bwd[("train_encoder", "bfloat16")]),
        kernel_line("fused_adam_ema", "fused_adam_ema.cu", "fused_adam.py:109", count("adam"),
                    adam["float32"]["err"], adam["float32"]),
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
    main()
