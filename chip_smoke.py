"""Smoke test of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which raises on failure:

  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the port's CUDA kernels from ops/csrc/;
  3. kernel vs plain: packed attention against its plain PyTorch version at
     the sampling path's shapes, in bf16 and fp32, with both times;
  4. weights: DiT-XL/2 at 256 px (decoder, MAE coef 0.1, 1000 classes) with
     every parameter drawn from a seeded normal (std 0.02), saved as a
     reference-layout ``{"ema": state_dict}`` checkpoint;
  5. main path: ``maskdit_tpu_torch.generate.main`` with that checkpoint,
     8 seeds, CFG 1.5, 40 EDM steps; checks the latents and that every
     attention call of the 79 denoiser evaluations launched the kernel;
  6. model parity: one CFG forward of the model with the kernel and with
     the plain attention swapped in, in bf16 and fp32.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")

# (name, N, L, heads, head dim): the encoder and decoder blocks of the
# sampling path (CFG batch 2 x 8), and the masked-training encoder shape
ATTN_SHAPES = [
    ("encoder", 16, 256, 16, 72),
    ("decoder", 16, 256, 16, 32),
    ("train_encoder", 16, 128, 16, 72),
]
# kernel vs plain bounds: bf16 rounds both outputs (and the probabilities)
# to 8 bits of mantissa; fp32 differs only by summation order
ATTN_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# whole-model bound on max|kernel - plain| / max|plain| of D(x; sigma)
MODEL_REL_BOUND = {torch.bfloat16: 5e-2, torch.float32: 1e-4}

SEEDS, STEPS, CFG = 8, 40, 1.5
DEPTH, DECODER_DEPTH = 28, 8


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
    return smi


def phase_build() -> None:
    from maskdit_tpu_torch.ops import build, flash_batched

    lib, seconds = build.build(flash_batched.KERNEL)
    log(f"[build] {lib.name} in {seconds:.2f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
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


def build_model(dtype: torch.dtype):
    from maskdit_tpu_torch.models import create_model

    return create_model(
        "edm", img_resolution=32, img_channels=4, num_classes=1000,
        model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1, dtype=dtype,
    )


def phase_weights() -> str:
    model = build_model(torch.bfloat16).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
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
    """Swap the plain attention into the model's layers, for comparison."""
    from maskdit_tpu_torch.models import layers
    from maskdit_tpu_torch.ops.flash_batched import packed_attention_reference

    kernel = layers.packed_attention
    layers.packed_attention = packed_attention_reference
    try:
        yield
    finally:
        layers.packed_attention = kernel


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
    torch.backends.cuda.matmul.allow_tf32 = False
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


def profile_forward(model, x, sigma, y) -> None:
    """Device time by kernel over 3 CFG forwards (one denoiser evaluation
    each), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        model(x, sigma, y, cfg_scale=CFG)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            model(x, sigma, y, cfg_scale=CFG)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x, sigma, y, cfg_scale=CFG)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in events) / 3 / 1e3
    launches = sum(e.count for e in events) // 3
    log(f"[profile] one CFG denoiser evaluation (batch {SEEDS} x 2): wall {wall_ms:.3f} ms "
        f"(unprofiled), device busy {busy_ms:.3f} ms in {launches} device ops (profiled), "
        f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 3 / 1e3:8.3f} ms  x{e.count // 3:4d}  "
            f"{e.key[:100]}")


def main() -> None:
    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    ckpt = phase_weights()
    try:
        main_path = phase_main(ckpt)
        parity = phase_model_parity(ckpt)
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    log(f"[summary] {smi}: main path {main_path['images_per_s']:.3f} images/s (cold), "
        f"warm {parity['sampling']['kernel']} images/s; model rel err bf16 "
        f"{parity['bfloat16']:.3e}, fp32 {parity['float32']:.3e}")
    enc = kernels[("encoder", "bfloat16")]
    err = max(kernels[(name, "bfloat16")]["err"] for name in ("encoder", "decoder"))
    print(json.dumps({"kernels": [{
        "name": "packed_attention_fwd",
        "route": "cuda",
        "source": "maskdit_tpu_torch/ops/csrc/packed_attention_fwd.cu",
        "replaces": "maskdit_tpu/ops/flash_batched.py:162",
        "launches": main_path["launches"],
        "max_abs_err": err,
        "ms": enc["ms"],
        "plain_ms": enc["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
