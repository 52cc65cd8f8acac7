"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Every phase runs; each raises on failure:

  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the port's three CUDA kernels from ops/csrc/, one
     nvcc per source, all started together, with their register and spill
     reports;
  3. kernel vs plain, each against its plain PyTorch version with both
     times: packed attention forward at the sampling and training shapes,
     its backward at the training shapes, both in bf16 and fp32; the fused
     Adam + EMA update over all of DiT-XL/2's parameters;
  4. sampling (the serving path): a random DiT-XL/2 at 256 px (decoder,
     MAE coef 0.1, 1000 classes, every parameter ~ N(0, 0.02^2)) saved as
     a reference ``{"ema": ...}`` checkpoint; ``maskdit_tpu_torch.generate``
     with it (8 seeds, CFG 1.5, 40 EDM steps), checking the latents and that
     all 79 x 36 attention calls launched the kernel; model parity kernel vs
     plain in bf16 and fp32; warm images/s; a profile of one evaluation;
  5. training (the train path): ``maskdit_tpu_torch.train.main`` on the
     released 256-px config at its batch of 128, cut to 12 steps, on
     synthetic latents; checks finite losses, 36 + 36 attention launches
     and one fused-update launch per step, and that resuming from the checkpoint
     restores it exactly; train-step parity kernels vs plain in fp32 and
     bf16; a profile of one train step.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
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

# (name, N, L, heads, head dim): the encoder and decoder blocks of the
# sampling path (CFG batch 2 x 8) and of the masked training path (the
# encoder at the 128 kept tokens)
ATTN_SHAPES = [
    ("encoder", 16, 256, 16, 72),
    ("decoder", 16, 256, 16, 32),
    ("train_encoder", TRAIN_BATCH, 128, 16, 72),
    ("train_decoder", TRAIN_BATCH, 256, 16, 32),
]
# kernel vs plain bounds: bf16 rounds both outputs (and the probabilities)
# to 8 bits of mantissa; fp32 differs only by summation order
ATTN_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# whole-model bound on max|kernel - plain| / max|plain| of D(x; sigma)
MODEL_REL_BOUND = {torch.bfloat16: 5e-2, torch.float32: 1e-4}

# the backward at the training path's shapes: encoder L128 hd72, decoder
# L256 hd32. Bound on max|kernel - plain| / max|plain|: fp32 sums
# in another order; bf16 may round ds, pb or the output one ulp (2^-8)
# the other way where the fp32 values differ in their last bits
# (and a ragged one: L not a multiple of the 32-row blocks, hd of 40)
BWD_SHAPES = [("train_encoder", TRAIN_BATCH, 128, 16, 72),
              ("train_decoder", TRAIN_BATCH, 256, 16, 32), ("ragged", 3, 77, 4, 40)]
BWD_REL_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# fused Adam: fp32 everywhere, the two differ by FMA contraction only, so
# per element |kernel - plain| <= 1e-6 |plain| + 1e-7; a bf16 mu by at most
# one bf16 ulp (2^-7 of the value) where that contraction flips a rounding
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7

SEEDS, STEPS, CFG = 8, 40, 1.5
DEPTH, DECODER_DEPTH = 28, 8

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
# attention calls per train step (28 encoder + 8 decoder blocks), each
# once forward and once backward; one fused update per step
ATTN_PER_STEP = DEPTH + DECODER_DEPTH
ADAM_PER_STEP = 1
# train-step parity, kernels vs plain, batch 8 from one state and draws:
# fp32 with TF32 off: sums in other orders; bf16: the attention kernels
# round probabilities, ds and outputs at the same points as the plain
# versions, but a last-bit fp32 difference can flip one bf16 rounding,
# which 36 layers and the backward carry into every gradient
PARITY_BATCH = 8
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
    from maskdit_tpu_torch.ops import build, flash_batched, fused_adam

    names = [flash_batched.KERNEL, flash_batched.BWD_KERNEL, fused_adam.KERNEL]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build.build, names))
    log(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s wall")
    for lib, seconds in built:
        log(f"[build] {lib.name} in {seconds:.2f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def phase_kernels() -> dict:
    from maskdit_tpu_torch.ops.flash_batched import (
        packed_attention,
        packed_attention_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, n, l, h, hd in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            with torch.no_grad():
                out = packed_attention(qkv, h, scale)
                torch.cuda.synchronize()
                ref = packed_attention_reference(qkv, h, scale)
                err = (out.float() - ref.float()).abs().max().item()
                bound = ATTN_BOUND[dtype]
                ms = cuda_ms(lambda: packed_attention(qkv, h, scale), 50)
                plain_ms = cuda_ms(lambda: packed_attention_reference(qkv, h, scale), 50)
            dt = str(dtype).replace("torch.", "")
            log(f"[kernel] {name} N={n} L={l} H={h} hd={hd} {dt}: "
                f"max_abs_err {err:.3e} (bound {bound:.0e}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not (np.isfinite(err) and err <= bound):
                raise AssertionError(f"packed_attention {name} {dt}: {err} > {bound}")
            results[(name, dt)] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return results


def phase_bwd_kernels() -> dict:
    from maskdit_tpu_torch.ops.flash_batched import (
        packed_attention_bwd,
        packed_attention_bwd_reference,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, n, l, h, hd in BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(n, l, 3 * h * hd, generator=g, device="cuda").to(dtype)
            dout = torch.randn(n, l, h * hd, generator=g, device="cuda").to(dtype)
            scale = hd ** -0.5
            before = packed_attention_bwd.launches
            got = packed_attention_bwd(qkv, dout, h, scale)
            torch.cuda.synchronize()
            launches = packed_attention_bwd.launches - before
            ref = packed_attention_bwd_reference(qkv, dout, h, scale).float()
            err = (got.float() - ref).abs().max().item()
            bound = BWD_REL_BOUND[dtype] * ref.abs().max().item()
            ms = cuda_ms(lambda: packed_attention_bwd(qkv, dout, h, scale), 20)
            plain_ms = cuda_ms(lambda: packed_attention_bwd_reference(qkv, dout, h, scale), 20)
            dt = str(dtype).replace("torch.", "")
            log(f"[kernel] attention bwd {name} N={n} L={l} H={h} hd={hd} {dt}: "
                f"max_abs_err {err:.3e} (bound {bound:.3e} = {BWD_REL_BOUND[dtype]:.0e} "
                f"x max|ref|); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                f"launches per call {launches}")
            if not (np.isfinite(err) and err <= bound and launches == 1):
                raise AssertionError(f"packed_attention_bwd {name} {dt}: {err} > {bound}")
            results[(name, dt)] = dict(err=err, ms=ms, plain_ms=plain_ms)
            del qkv, dout, got, ref
    return results


def xl2_numel() -> int:
    """Parameters of DiT-XL/2 @256 with the decoder and MAE token, counted
    on the meta device (nothing is allocated)."""
    with torch.device("meta"):
        model = build_model(torch.bfloat16)
    return sum(p.numel() for p in model.parameters())


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
        dt = str(m_dtype).replace("torch.", "")
        ms = cuda_ms(lambda: fused_adam.fused_adam_ema(grads, *got, lr=1e-4, count_inc=7), 10)
        plain_ms = cuda_ms(lambda: fused_adam.fused_adam_ema_reference(grads, p, m, v, e, **scalars), 5)
        moved = n * (4 * 4 + 4 * 3 + 2 * m.element_size())  # reads g,p,v,e,m; writes p,v,e,m
        log(f"[kernel] fused adam over {n} params (DiT-XL/2), mu {dt}: max_abs_err {err:.3e} "
            f"(bound per element {ADAM_RTOL:.0e}|ref| + {ADAM_ATOL:.0e}); kernel {ms:.4f} ms "
            f"({moved / ms / 1e6:.1f} GB/s, floor {moved / 3.35e12 * 1e3:.3f} ms at 3.35 TB/s), "
            f"plain {plain_ms:.4f} ms; launches per update {launches}")
        if not ok:
            raise AssertionError(f"fused_adam_ema mu {dt}: err {err}, launches {launches}")
        out[dt] = dict(err=err, ms=ms, plain_ms=plain_ms, gbps=moved / ms / 1e6)
        del m, want, got
    del grads, p, e, v
    free_device_memory()
    return out


def build_model(dtype: torch.dtype):
    from maskdit_tpu_torch.models import create_model

    return create_model(
        "edm", img_resolution=32, img_channels=4, num_classes=1000,
        model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1, dtype=dtype,
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
    path = os.path.join(SCRATCH, "random-xl2-256.pt")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    torch.save({"ema": state}, path)
    log(f"[weights] DiT-XL/2 @256, {n_params} params ~ N(0, 0.02^2), seed 0; "
        f"saved in {time.perf_counter() - t0:.1f} s")
    return path


def phase_main(ckpt: str) -> dict:
    from maskdit_tpu_torch import generate
    from maskdit_tpu_torch.ops.flash_batched import packed_attention

    outdir = os.path.join(SCRATCH, "samples")
    shutil.rmtree(outdir, ignore_errors=True)
    argv = [
        "--ckpt_path", ckpt, "--outdir", outdir, "--no_decode",
        "--seeds", f"0-{SEEDS - 1}", "--max_batch_size", str(SEEDS),
        "--cfg_scale", str(CFG), "--num_steps", str(STEPS),
        "--model_type", "DiT-XL/2", "--image_size", "32", "--image_channels", "4",
        "--num_classes", "1000", "--use_decoder", "True", "--mae_loss_coef", "0.1",
    ]
    packed_attention.launches = 0
    result = generate.main(argv)
    launches = packed_attention.launches
    expected = (2 * STEPS - 1) * (DEPTH + DECODER_DEPTH)
    z = np.load(os.path.join(outdir, "latents_000000.npy"))
    log(f"[main] latents {z.shape} {z.dtype}, finite {bool(np.isfinite(z).all())}, "
        f"std {float(z.std()):.4f}")
    log(f"[main] packed_attention launches {launches} (expected {expected})")
    ips = result["images"] / result["seconds"]
    log(f"[main] {result['images']} images, {STEPS} steps, CFG {CFG}, bf16: "
        f"{result['seconds']:.3f} s, {ips:.3f} images/s (first batch, no warm-up)")
    if z.shape != (SEEDS, 4, 32, 32) or not np.isfinite(z).all():
        raise AssertionError(f"bad latents: shape {z.shape}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    return dict(launches=launches, images_per_s=ips, seconds=result["seconds"])


@contextlib.contextmanager
def plain_attention():
    """Swap the plain attention (forward and backward) into the model's
    layers, for comparison."""
    from maskdit_tpu_torch.models import layers
    from maskdit_tpu_torch.ops.flash_batched import packed_attention_plain

    kernel = layers.packed_attention
    layers.packed_attention = packed_attention_plain
    try:
        yield
    finally:
        layers.packed_attention = kernel


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


def phase_model_parity(ckpt: str) -> dict:
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params
    from maskdit_tpu_torch.utils.ckpt import load_into, load_reference_checkpoint

    state = load_reference_checkpoint(ckpt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(SEEDS, 4, 32, 32)).astype(np.float32)).cuda()
    sigma = torch.from_numpy(rng.uniform(0.5, 5.0, size=SEEDS).astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 1000, size=SEEDS)), 1000
    ).float().cuda()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = build_model(dtype)
        load_into(model, state)
        model = model.cuda().eval()
        with torch.no_grad():
            got = model(x, sigma, y, cfg_scale=CFG)["x"]
            with plain_attention():
                ref = model(x, sigma, y, cfg_scale=CFG)["x"]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        dt = str(dtype).replace("torch.", "")
        bound = MODEL_REL_BOUND[dtype]
        log(f"[parity] EDMPrecond CFG forward, batch {SEEDS}, {dt}: kernel vs plain "
            f"max rel err {rel:.3e} (bound {bound:.0e}), finite "
            f"{bool(torch.isfinite(got).all())}")
        if not (torch.isfinite(got).all() and rel <= bound):
            raise AssertionError(f"model parity {dt}: {rel} > {bound}")
        out[dt] = rel
        if dtype == torch.bfloat16:
            out["sampling"] = time_sampling(model, generate_with_params, SamplerConfig)
            profile_forward(model, x, sigma, y)
        del model
    free_device_memory()
    return out


def time_sampling(model, generate_with_params, SamplerConfig) -> dict:
    """Warm images/s of the whole sampler at batch 8, with the kernel and
    with the plain attention, in turns: plain, kernel, kernel, plain."""
    cfg = SamplerConfig(num_steps=STEPS, cfg_scale=CFG)
    seeds = list(range(SEEDS))
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        ctx = plain_attention() if which == "plain" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_with_params(model, seeds, None, cfg, max_batch_size=SEEDS)
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
    ips = {k: [SEEDS / t for t in v] for k, v in times.items()}
    log(f"[sampling] warm, batch {SEEDS}, {STEPS} steps, CFG {CFG}, bf16: images/s "
        f"kernel {ips['kernel']}, plain {ips['plain']}")
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


def profile_forward(model, x, sigma, y) -> None:
    """Device time by kernel over 3 CFG forwards (one denoiser evaluation
    each), from torch.profiler."""
    def evaluate():
        with torch.no_grad():
            model(x, sigma, y, cfg_scale=CFG)

    profile_device("profile", evaluate, 3, f"one CFG denoiser evaluation (batch {SEEDS} x 2)")


def phase_train() -> dict:
    """The train main path through the CLI, then resume from its checkpoint."""
    from maskdit_tpu_torch.ops import flash_batched, fused_adam
    from maskdit_tpu_torch.train import main as train_main
    from maskdit_tpu_torch.utils.profiling import (
        maskdit_train_flops_per_image,
        mfu,
        peak_bf16_tflops,
    )

    os.makedirs(SCRATCH, exist_ok=True)
    config = os.path.join(SCRATCH, "train-xl2-256.json")
    with open(config, "w") as f:
        json.dump(TRAIN_CONFIG, f)
    results = os.path.join(SCRATCH, "train")
    shutil.rmtree(results, ignore_errors=True)
    free_device_memory()
    flash_batched.packed_attention.launches = 0
    flash_batched.packed_attention_bwd.launches = 0
    fused_adam.fused_adam_ema.launches = 0
    out = train_main(["--config", config, "--results_dir", results, "--device", "cuda",
                      "--num_workers", "4"])
    launches = dict(fwd=flash_batched.packed_attention.launches,
                    bwd=flash_batched.packed_attention_bwd.launches,
                    adam=fused_adam.fused_adam_ema.launches)
    steps, history = out["step"], out["history"]
    losses = [x for r in history for x in r["losses"]]
    expect = dict(fwd=ATTN_PER_STEP * steps, bwd=ATTN_PER_STEP * steps, adam=ADAM_PER_STEP * steps)
    log(f"[train] {steps} steps of DiT-XL/2 @256, batch {TRAIN_BATCH}, mask 0.5, bf16: "
        f"losses {[round(x, 4) for x in losses]}")
    log(f"[train] launches {launches} (expected {expect}: per step {ATTN_PER_STEP} forward, "
        f"{ATTN_PER_STEP} backward, {ADAM_PER_STEP} fused update)")
    if steps != TRAIN_STEPS or len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"training: {steps} steps, losses {losses}")
    if launches != expect:
        raise AssertionError(f"training launches {launches} != {expect}")
    warm = history[1:]  # the first window holds steps 1-2 (warm-up)
    seconds = sum(LOG_EVERY / r["steps_per_sec"] for r in warm)
    warm_steps = LOG_EVERY * len(warm)
    ips = warm_steps * TRAIN_BATCH / seconds
    name = torch.cuda.get_device_name(0)
    flops = maskdit_train_flops_per_image("DiT-XL/2", 32, 0.5, True)
    util = mfu(ips, flops, peak_bf16_tflops(name))
    peak = max(r["mem_peak_gib"] for r in history)
    log(f"[train] warm steps {2 + 1}-{steps}: {ips:.2f} images/s, {seconds / warm_steps * 1e3:.1f} "
        f"ms/step, MFU {util:.4f} of {peak_bf16_tflops(name):.0f} TFLOP/s bf16 "
        f"({flops / 1e9:.1f} GFLOP/image), peak memory {peak:.2f} GiB; per window images/s "
        f"{[round(r['images_per_sec'], 2) for r in history]}")
    resume = check_resume(results)
    return dict(launches=launches, images_per_s=ips, ms_per_step=seconds / warm_steps * 1e3,
                mfu=util, peak_gib=peak, resume=resume)


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


def train_parity_state(dtype: torch.dtype, seed: int):
    """A DiT-XL/2 train state with random weights and a non-trivial Adam
    state (count 10, mu ~ N(0, 1e-4^2), nu ~ |N(0, 1e-7^2)|), the same for
    the same seed."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer

    torch.manual_seed(seed)
    model = build_model(dtype).cuda()
    random_weights_(model)
    opt = make_optimizer(1e-4, PARITY_BATCH)
    state = create_train_state(model, opt)
    g = torch.Generator(device="cuda").manual_seed(seed)
    state.opt_state.count = 10
    state.opt_state.mu.normal_(0.0, 1e-4, generator=g)
    state.opt_state.nu.normal_(0.0, 1e-7, generator=g).abs_()
    return state, opt


def phase_parity_train() -> dict:
    """One train step from one state with the same injected draws, through
    the kernels and through the plain attention and update."""
    from maskdit_tpu_torch.models.masking import random_mask
    from maskdit_tpu_torch.train.state import StepDraws, make_train_step

    g = torch.Generator(device="cuda").manual_seed(3)
    n = PARITY_BATCH
    batch = {"x": torch.randn(n, 8, 32, 32, device="cuda", generator=g),
             "y": torch.nn.functional.one_hot(
                 torch.randint(0, 1000, (n,), device="cuda", generator=g), 1000).float()}
    draws = StepDraws(
        z_noise=torch.randn(n, 4, 32, 32, device="cuda", generator=g),
        drop_u=torch.rand(n, 1, device="cuda", generator=g),
        sigma=torch.exp(torch.randn(n, device="cuda", generator=g) * 1.2 - 1.2),
        noise=torch.randn(n, 4, 32, 32, device="cuda", generator=g),
        mask_info=random_mask(n, 256, 0.5, g, device="cuda"),
    )
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for which in ("kernel", "plain"):
            free_device_memory()
            state, opt = train_parity_state(dtype, seed=4)
            step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.9999)
            ctx = contextlib.ExitStack()
            if which == "plain":
                ctx.enter_context(plain_attention())
                ctx.enter_context(plain_update())
            with ctx:
                metrics = step(state, batch, draws=draws)
            torch.cuda.synchronize()
            runs[which] = dict(
                loss=float(metrics["loss"]),
                grads={k: v.clone() for k, v in state.named(state.grads).items()},
                state={f"{name}.{k}": v.clone() for name, flat in (
                    ("p", state.params), ("ema", state.ema), ("mu", state.opt_state.mu),
                    ("nu", state.opt_state.nu)) for k, v in state.named(flat).items()},
            )
            del state, opt, step, metrics
        got, ref = runs["kernel"], runs["plain"]
        rel_norm = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        loss_err = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        grad_err = max(rel_norm(got["grads"][k], v) for k, v in ref["grads"].items())
        worst = max(ref["grads"], key=lambda k: rel_norm(got["grads"][k], ref["grads"][k]))
        state_err = max(rel_norm(got["state"][k], v) for k, v in ref["state"].items())
        # a gradient that reaches the encoder's first qkv passed through
        # every attention backward above it
        qkv_norm = got["grads"]["model.blocks.0.attn.qkv.weight"].norm().item()
        bound = TRAIN_PARITY_BOUND[dtype]
        dt = str(dtype).replace("torch.", "")
        log(f"[parity-train] one step, DiT-XL/2, batch {n}, {dt}: loss kernel {got['loss']:.6f} "
            f"plain {ref['loss']:.6f}, rel err {loss_err:.3e} (bound {bound['loss']:.0e}); "
            f"max per-tensor gradient rel-norm err {grad_err:.3e} (bound {bound['grad']:.0e}, "
            f"worst {worst}); max per-tensor p/ema/mu/nu rel-norm err {state_err:.3e} "
            f"(bound {bound['state']:.0e}); |grad| of blocks.0.attn.qkv {qkv_norm:.3e}")
        if not (loss_err <= bound["loss"] and grad_err <= bound["grad"]
                and state_err <= bound["state"] and qkv_norm > 0):
            raise AssertionError(f"train parity {dt}: loss {loss_err}, grad {grad_err}, "
                                 f"state {state_err}")
        out[dt] = dict(loss=loss_err, grad=grad_err, state=state_err)
        del runs, got, ref
    free_device_memory()
    return out


def phase_train_profile() -> None:
    """Device time by kernel over warm train steps at the main path's batch
    (bf16, batch 128), from torch.profiler."""
    from maskdit_tpu_torch.data.datasets import SyntheticLatentDataset
    from maskdit_tpu_torch.data.loader import DataLoader
    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step

    free_device_memory()
    torch.manual_seed(0)
    model = create_model("edm", img_resolution=32, img_channels=4, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1).cuda()
    opt = make_optimizer(1e-4, TRAIN_BATCH)
    state = create_train_state(model, opt)
    step = make_train_step(opt, mask_ratio=0.5, mae_loss_coef=0.1)
    loader = DataLoader(SyntheticLatentDataset(TRAIN_BATCH, 32, 4, 1000), TRAIN_BATCH, num_workers=4)
    host = next(iter(loader))
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    step(state, batch, gen)
    profile_device("train-profile", lambda: step(state, batch, gen), 3,
                   f"one train step (DiT-XL/2, batch {TRAIN_BATCH}, mask 0.5, bf16)")
    log(f"[train-profile] peak memory {torch.cuda.max_memory_allocated() / 1024 ** 3:.2f} GiB")
    del model, opt, state, step
    free_device_memory()


def main() -> None:
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    bwd = phase_bwd_kernels()
    adam = phase_adam_kernel()
    try:
        ckpt = phase_weights()
        main_path = phase_main(ckpt)
        parity = phase_model_parity(ckpt)
        train = phase_train()
        parity_train = phase_parity_train()
        phase_train_profile()
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[summary] {smi}: sampling {main_path['images_per_s']:.3f} images/s (cold), "
        f"warm {parity['sampling']['kernel']} images/s; model rel err bf16 "
        f"{parity['bfloat16']:.3e}, fp32 {parity['float32']:.3e}; training "
        f"{train['images_per_s']:.2f} images/s, MFU {train['mfu']:.4f}, peak "
        f"{train['peak_gib']:.2f} GiB; train parity {parity_train}")
    enc = kernels[("encoder", "bfloat16")]
    fwd_err = max(kernels[(name, "bfloat16")]["err"] for name, *_ in ATTN_SHAPES)
    bwd_enc = bwd[("train_encoder", "bfloat16")]
    bwd_err = max(bwd[(name, "bfloat16")]["err"] for name in ("train_encoder", "train_decoder"))
    print(json.dumps({"kernels": [
        {"name": "packed_attention_fwd", "route": "cuda",
         "source": "maskdit_tpu_torch/ops/csrc/packed_attention_fwd.cu",
         "replaces": "maskdit_tpu/ops/flash_batched.py:162",
         "launches": main_path["launches"] + train["launches"]["fwd"],
         "max_abs_err": fwd_err, "ms": enc["ms"], "plain_ms": enc["plain_ms"]},
        {"name": "packed_attention_bwd", "route": "cuda",
         "source": "maskdit_tpu_torch/ops/csrc/packed_attention_bwd.cu",
         "replaces": "maskdit_tpu/ops/flash_batched.py:177",
         "launches": train["launches"]["bwd"],
         "max_abs_err": bwd_err, "ms": bwd_enc["ms"], "plain_ms": bwd_enc["plain_ms"]},
        {"name": "fused_adam_ema", "route": "cuda",
         "source": "maskdit_tpu_torch/ops/csrc/fused_adam_ema.cu",
         "replaces": "maskdit_tpu/ops/fused_adam.py:109",
         "launches": train["launches"]["adam"],
         "max_abs_err": adam["float32"]["err"], "ms": adam["float32"]["ms"],
         "plain_ms": adam["float32"]["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
