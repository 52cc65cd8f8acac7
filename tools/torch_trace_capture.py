"""Capture a torch.profiler trace of the DiT-XL/2 train step (or sampler) on the card.

The twin of tools/trace_capture.py:

  python tools/torch_trace_capture.py build/trace_256_bs48          # plain step
  PROBE_RES=64 PROBE_BATCH=16 python tools/torch_trace_capture.py OUT
  PROBE_RES=64 PROBE_BATCH=56 PROBE_GA=8 PROBE_ACC=bfloat16 PROBE_AMP=1 \
      python tools/torch_trace_capture.py OUT
  PROBE_MODE=sample PROBE_STEPS=40 python tools/torch_trace_capture.py OUT

The environment knobs are tools/perf_probe.py's: PROBE_RES (latent
resolution, 32 = 256 px), PROBE_BATCH (default 48), PROBE_GA (gradient
accumulation), PROBE_AMP=1 (bf16 gradients), PROBE_ACC (the accumulator's
dtype), PROBE_FLASH=0 (plain attention; else the attention route's auto
choice), PROBE_MU (the Adam first moment's dtype) and PROBE_REMAT (the
model's activation rematerialisation: none or 0, full, dots, names,
names_lite; models/remat.py); PROBE_MODE=sample
traces the CFG EDM sampler instead (PROBE_STEPS, default 40; PROBE_BATCH,
default 128 at 256 px, 32 at 512). It warms up, prints the first and the
steady times, then traces N_STEPS (default 3) steps (N_STEPS // 3 sampler
runs) under ``utils/profiling.trace``, which writes a Chrome trace under
the output directory. Read it with tools/torch_trace_report.py.

Where it differs from the JAX tool: ``--device`` (default cuda; a missing
card raises); the output directory defaults to ``build/trace_step`` in the
checkout; an unknown PROBE_REMAT raises (the JAX model runs it without
remat); the weights are initialised from ``torch.manual_seed(0)`` and the
batch drawn from a torch generator seeded 1. The model type is
``MODEL_TYPE``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TYPE = "DiT-XL/2"
NUM_CLASSES = 1000


def _model(res: int, device: torch.device, use_flash=None, remat=False):
    from maskdit_tpu_torch.models import create_model

    torch.manual_seed(0)
    with device:  # initialised on the device: a DiT-XL/2's init is slow on the host
        model = create_model(
            "edm", img_resolution=res, img_channels=4, num_classes=NUM_CLASSES,
            model_type=MODEL_TYPE, use_decoder=True, mae_loss_coef=0.1,
            dtype=torch.bfloat16, use_flash=use_flash, remat=remat,
        )
    return model.to(device)


def build(env, device: torch.device):
    """tools/perf_probe.py's ``build``: the model, the optimizer, its train
    state and one batch of moments and one-hot labels."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer

    remat = env.get("PROBE_REMAT", "none")
    batch_size = int(env.get("PROBE_BATCH", "48"))
    res = int(env.get("PROBE_RES", "32"))  # latent res: 32 = 256 px, 64 = 512 px
    flash = False if env.get("PROBE_FLASH") == "0" else None
    model = _model(res, device, flash, remat=False if remat in ("none", "0") else remat)
    opt = make_optimizer(1e-4, global_batch_size=batch_size,
                         moment_dtype=env.get("PROBE_MU") or None)
    state = create_train_state(model, opt)
    g = torch.Generator(device=device).manual_seed(1)
    batch = {
        "x": torch.randn((batch_size, 8, res, res), generator=g, device=device),
        "y": torch.nn.functional.one_hot(
            torch.randint(0, NUM_CLASSES, (batch_size,), generator=g, device=device),
            NUM_CLASSES).float(),
    }
    return model, opt, state, batch, g


def _sample_main(out_dir: str, n_steps: int, env, device: torch.device) -> dict:
    """PROBE_MODE=sample: trace the inference path (the CFG EDM sampler)."""
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, make_sample_fn
    from maskdit_tpu_torch.utils.profiling import trace

    res = int(env.get("PROBE_RES", "32"))
    batch = int(env.get("PROBE_BATCH", "128" if res == 32 else "32"))
    num_steps = int(env.get("PROBE_STEPS", "40"))
    model = _model(res, device).eval()
    fn = make_sample_fn(model, SamplerConfig(num_steps=num_steps, cfg_scale=1.5))
    g = torch.Generator(device=device).manual_seed(1)
    latents = torch.randn((batch, 4, res, res), generator=g, device=device)
    labels = torch.nn.functional.one_hot(
        torch.arange(batch, device=device) % NUM_CLASSES, NUM_CLASSES).float()
    t0 = time.perf_counter()
    z = fn(latents, labels)
    float(z.float().sum())
    first = time.perf_counter() - t0
    print(f"compile+first: {first:.1f}s", flush=True)
    t0 = time.perf_counter()
    z = fn(latents, labels)
    float(z.float().sum())
    dt = time.perf_counter() - t0
    print(f"steady: {dt * 1e3:.0f} ms/batch ({batch / dt:.2f} imgs/s)", flush=True)
    with trace(out_dir):
        for _ in range(n_steps):
            z = fn(latents, labels)
        float(z.float().sum())
    print(f"trace written to {out_dir}", flush=True)
    return dict(first_s=first, steady_ms=dt * 1e3, trace_dir=out_dir, runs=n_steps)


def main(argv=None, env=None) -> dict:
    """Capture the trace; ``env`` (default os.environ) holds the knobs.
    Returns the first and steady times, the directory and the traced
    steps (and in train mode the model's remat policy, None for none)."""
    from maskdit_tpu_torch.train.state import make_train_step
    from maskdit_tpu_torch.utils.profiling import trace

    p = argparse.ArgumentParser()
    p.add_argument("out_dir", nargs="?", default=os.path.join(ROOT, "build", "trace_step"))
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    env = os.environ if env is None else env
    device = torch.device(args.device)
    out_dir = args.out_dir
    n_steps = int(env.get("N_STEPS", "3"))
    if env.get("PROBE_MODE") == "sample":
        return _sample_main(out_dir, max(1, n_steps // 3), env, device)

    model, opt, state, batch, g = build(env, device)
    ga = int(env.get("PROBE_GA", "1"))
    amp = env.get("PROBE_AMP", "0") == "1"
    acc = env.get("PROBE_ACC") or None
    step = make_train_step(
        opt, mask_ratio=0.5, mae_loss_coef=0.1, class_dropout_prob=0.1,
        log_grad_norm=False, grad_accum=ga, amp_grads=amp, accum_dtype=acc,
    )
    t0 = time.perf_counter()
    m = step(state, batch, g)
    float(m["loss"])
    first = time.perf_counter() - t0
    print(f"compile+first: {first:.1f}s", flush=True)
    for _ in range(2):
        m = step(state, batch, g)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(5):
        m = step(state, batch, g)
    float(m["loss"])
    dt = (time.perf_counter() - t0) / 5
    print(f"steady state: {dt * 1e3:.1f} ms/step", flush=True)

    with trace(out_dir):
        for _ in range(n_steps):
            m = step(state, batch, g)
        float(m["loss"])
    print(f"trace written to {out_dir}", flush=True)
    return dict(first_s=first, steady_ms=dt * 1e3, trace_dir=out_dir, runs=n_steps,
                remat=model.model.remat)


if __name__ == "__main__":
    main()
