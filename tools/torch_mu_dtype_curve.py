"""Loss-curve equivalence check for narrow Adam-state storage, on the port.

The twin of tools/mu_dtype_curve.py: the same small MaskDiT (DiT-S/2 at
16 x 16 latents, 16 classes, a decoder, MAE coefficient 0.1, bf16) trained
twice from the same seeds, once with fp32 Adam state and once with the
narrow variant, on the same synthetic stream (lr 1e-4, batch 32, mask 0.5,
class dropout 0.1), and the per-step loss gap reported with the JAX tool's
keys. Over N steps the two curves must track within optimizer-noise scale
(no drift, no divergence); the per-step rounding bounds live in
tests/test_torch_fused_adam.py and tests/test_torch_fused_adam_sr.py.

Variants:
  mu    — moment_dtype='bfloat16' (first moment, round-to-nearest)
  nu    — nu_dtype='bfloat16' (second moment, stochastic rounding)
  munu  — both narrow

Usage:  python tools/torch_mu_dtype_curve.py [steps=200] [out.json] [variant=mu]
            [--device cuda]

The update is the port's fused Adam + EMA (``make_optimizer``'s default):
on the card kernel #7 (ops/csrc/fused_adam_ema.cu) in fp32, with a bf16 mu,
with a stochastically rounded bf16 nu, or both; on the CPU #7's plain
version, which computes the same function. That is the math of the JAX
tool's ``fused="jnp"`` update. Where it differs from the JAX tool: step i's
batch and its draws (sigma, noise, mask, label dropout) come from a torch
generator seeded 100 + i, not from threefry, so its numbers are the port's
own; ``--device`` picks the device (a missing card raises).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

VARIANTS = {
    "mu": {"moment_dtype": "bfloat16"},
    "nu": {"nu_dtype": "bfloat16"},
    "munu": {"moment_dtype": "bfloat16", "nu_dtype": "bfloat16"},
}


def run(steps: int, *, moment_dtype=None, nu_dtype=None, device: str = "cuda"):
    """Train ``steps`` steps from seed 0 (the weights drawn on the device);
    returns the per-step losses."""
    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    torch.manual_seed(0)
    with torch.device(device):  # initialised on the device
        model = create_model(
            "edm", img_resolution=16, img_channels=4, num_classes=16,
            model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1,
            dtype=torch.bfloat16,
        ).to(device)  # the sin-cos tables are made on the host
    opt = make_optimizer(
        1e-4, global_batch_size=32, moment_dtype=moment_dtype, nu_dtype=nu_dtype,
    )
    state = create_train_state(model, opt)
    step = make_train_step(
        opt, mask_ratio=0.5, mae_loss_coef=0.1, class_dropout_prob=0.1,
        log_grad_norm=False,
    )
    losses = []
    for i in range(steps):
        g = torch.Generator(device=device).manual_seed(100 + i)
        batch = {
            "x": torch.randn((32, 8, 16, 16), generator=g, device=device),
            "y": torch.nn.functional.one_hot(
                torch.randint(0, 16, (32,), generator=g, device=device), 16
            ).float(),
        }
        metrics = step(state, batch, g)
        losses.append(metrics["loss"])
    return [float(x) for x in torch.stack(losses).cpu()]


def report_of(variant: str, steps: int, l32: list, l16: list) -> dict:
    """The JAX tool's report of an fp32 and a narrow loss curve."""
    gaps = [abs(a - b) for a, b in zip(l32, l16)]
    tail32 = sum(l32[-20:]) / 20
    tail16 = sum(l16[-20:]) / 20
    return {
        "variant": variant,
        "steps": steps,
        "final_loss_fp32": l32[-1],
        f"final_loss_{variant}": l16[-1],
        "tail20_mean_fp32": tail32,
        f"tail20_mean_{variant}": tail16,
        "tail20_gap": abs(tail32 - tail16),
        "max_step_gap": max(gaps),
        "mean_step_gap": sum(gaps) / len(gaps),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("steps", nargs="?", type=int, default=200)
    p.add_argument("out", nargs="?", default=None)
    p.add_argument("variant", nargs="?", default="mu", choices=list(VARIANTS))
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    steps, out, variant = args.steps, args.out, args.variant
    narrow_kwargs = VARIANTS[variant]
    l32 = run(steps, device=args.device)
    l16 = run(steps, device=args.device, **narrow_kwargs)
    report = report_of(variant, steps, l32, l16)
    print(json.dumps(report, indent=2))
    if out:
        with open(out, "w") as f:
            json.dump({"report": report, "fp32": l32, variant: l16}, f)
    return report


if __name__ == "__main__":
    main()
