"""Offline validation of a released checkpoint on the PyTorch port.

The twin of tools/validate_port.py, with its flags, defaults and printed
lines, plus ``--device`` (default cuda; a missing card raises, nothing
falls back to the CPU):

  python tools/torch_validate_port.py --ckpt_path imagenet256-guidance.pt \
      --use_decoder True --mae_loss_coef 0.1 \
      [--vae_path autoencoder_kl.pth] [--sample] [--device cuda]

Checks, in order:
  1. coverage: the ``ema`` and ``model`` state dicts of the file (read once,
     ``utils/ckpt.load_reference_states``), the tensors other than the
     recomputed pos-embed tables counted against the model parameters the
     file fills (``utils/ckpt.graft_params`` on a model from
     ``create_model``), each non-finite tensor named;
  2. the EMA / model delta, max|ema - model| (0 would be suspicious);
  3. denoiser sanity: ``EDMPrecond`` in bf16 on the device at sigma in
     ``SIGMAS``, ||D|| / ||x|| and ||D - c_skip * sigma * x|| with c_skip =
     0.25 / (sigma^2 + 0.25) (``sigma_table``, which takes x and y);
  4. ``--sample``: 8 images, CFG 1.5, 40 steps through the port's
     ``sampling/generate``; decoded by the SD-VAE of ``--vae_path`` into
     PNGs, or without it written as latents.

Where it differs from the JAX tool: the names it prints are the state
dict's keys, not the converted Flax tree's paths; x is drawn from a torch
generator seeded 1 (JAX threefry draws are not reproduced), so the sigma
table's numbers are the port's own; keys that the file has and the model
lacks, or parameters the file does not fill (which stay 0, as in the JAX
tool's graft onto zeros), are named on lines of their own.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from maskdit_tpu_torch.models import DIT_CONFIGS, create_model
from maskdit_tpu_torch.utils.ckpt import graft_params, load_reference_states
from maskdit_tpu_torch.utils.logging import str2bool

SIGMAS = (0.02, 0.5, 2.0, 20.0, 80.0)
LABELS = (207, 360, 387, 974)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--model_type", default="DiT-XL/2", choices=list(DIT_CONFIGS))
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--num_classes", type=int, default=1000)
    p.add_argument("--use_decoder", type=str2bool, default=True)
    p.add_argument("--mae_loss_coef", type=float, default=0.1)
    p.add_argument("--pad_cls_token", type=str2bool, default=False)
    p.add_argument("--vae_path", default=None)
    p.add_argument("--sample", action="store_true")
    p.add_argument("--outdir", default="port_check")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    return p


def build_model(args: argparse.Namespace, dtype: torch.dtype = torch.bfloat16):
    """The checked model (EDMPrecond) with zero parameters, on the device
    (initialised there: a DiT-XL/2's initialisation is slow on the host)."""
    with torch.device(args.device):
        model = create_model(
            "edm", img_resolution=args.image_size, img_channels=4,
            num_classes=args.num_classes, model_type=args.model_type,
            use_decoder=args.use_decoder, mae_loss_coef=args.mae_loss_coef,
            pad_cls_token=args.pad_cls_token, dtype=dtype,
        )
    return model.to(args.device).eval().requires_grad_(False)


def graft_zeroed(model, state: dict) -> list[str]:
    """Zero the model's parameters and overlay ``state`` (the JAX tool's
    graft onto zeros); returns the parameters the file lacks."""
    target = model.state_dict()
    with torch.no_grad():
        for v in target.values():
            v.zero_()
    return graft_params(target, state)


def coverage(model, states: dict) -> dict:
    """Per state dict (``ema``, ``model``): its tensors other than the
    pos-embed tables (``n_src``), the model parameters it fills
    (``n_dst``), its non-finite tensors, its keys the model lacks
    (``unused``) and the parameters it does not fill (``unfilled``)."""
    params = model.state_dict()
    out = {}
    for key in ("ema", "model"):
        state = states[key]
        src = [k for k in state if not k.endswith("pos_embed")]
        unfilled = graft_zeroed(model, state)
        out[key] = dict(
            n_src=len(src), n_dst=len(params) - len(unfilled),
            non_finite=[k for k in src if not bool(torch.isfinite(state[k]).all())],
            unused=sorted(k for k in src if k not in params), unfilled=unfilled,
        )
    return out


def ema_delta(states: dict) -> float:
    """max|ema - model| over the tensors both state dicts hold."""
    ema, raw = states["ema"], states["model"]
    return max(float((ema[k] - raw[k]).abs().max())
               for k in ema if k in raw and not k.endswith("pos_embed"))


def denoiser_inputs(args: argparse.Namespace) -> tuple[torch.Tensor, torch.Tensor]:
    """x ~ N(0, 1) (4, 4, S, S) from a torch generator seeded 1, and the
    JAX tool's four one-hot labels (mod the class count)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((len(LABELS), 4, args.image_size, args.image_size), generator=g)
    y = torch.nn.functional.one_hot(torch.tensor(LABELS) % args.num_classes,
                                    args.num_classes).float()
    return x.to(args.device), y.to(args.device)


def sigma_table(model, x: torch.Tensor, y: torch.Tensor, sigmas=SIGMAS) -> list[dict]:
    """Per sigma: ||D(sigma x; sigma)|| / ||x|| and ||D - c_skip sigma x||,
    c_skip = 0.25 / (sigma^2 + 0.25), the norms in fp64."""
    rows = []
    x64 = x.double()
    with torch.no_grad():
        for sigma in sigmas:
            s = torch.full((x.shape[0],), sigma, dtype=torch.float32, device=x.device)
            d = model(x * sigma, s, y)["x"].double()
            c_skip = 0.25 / (sigma ** 2 + 0.25)
            rows.append(dict(sigma=sigma,
                             norm_ratio=float(d.norm() / x64.norm()),
                             resid=float((d - c_skip * x64 * sigma).norm())))
    return rows


def sample(model, args: argparse.Namespace) -> str:
    """8 seeds, CFG 1.5, 40 steps: PNGs through the SD-VAE of
    ``--vae_path``, else latents."""
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params

    vae = None
    if args.vae_path:
        from maskdit_tpu_torch.utils.port import load_vae

        vae = load_vae(args.vae_path).to(args.device)
    generate_with_params(
        model, list(range(8)), args.outdir, SamplerConfig(num_steps=40, cfg_scale=1.5),
        vae=vae, max_batch_size=8, save_latents=vae is None,
    )
    return args.outdir


def main(argv=None) -> dict:
    """Run the four checks; returns their results, the checked model (the
    file's EMA weights) and the sigma table's inputs."""
    args = build_parser().parse_args(argv)
    states = load_reference_states(args.ckpt_path)
    model = build_model(args)

    # 1. conversion coverage
    cover = coverage(model, states)
    for key, c in cover.items():
        print(f"[{key}] {c['n_src']} checkpoint tensors -> {c['n_dst']} params")
        for name in c["non_finite"]:
            print(f"  NON-FINITE: {name}")
        for name in c["unused"]:
            print(f"  UNUSED: {name}")
        for name in c["unfilled"]:
            print(f"  NOT IN FILE: {name}")

    # 2. EMA/model delta
    delta = ema_delta(states)
    print(f"EMA vs model: max|delta|={delta:.3e} (0 would be suspicious)")

    # 3. denoiser sanity across sigmas
    graft_zeroed(model, states["ema"])
    del states
    x, y = denoiser_inputs(args)
    print("sigma -> ||D||/||x||, ||D - c_skip*x||:")
    table = sigma_table(model, x, y)
    for row in table:
        print(f"  {row['sigma']:6.2f} -> {row['norm_ratio']:8.4f}, {row['resid']:10.2f}")

    # 4. optional sample
    outdir = None
    if args.sample:
        outdir = sample(model, args)
        print(f"wrote samples to {outdir}")
    return dict(coverage=cover, ema_delta=delta, table=table, outdir=outdir, model=model,
                inputs=(x, y))


if __name__ == "__main__":
    main()
