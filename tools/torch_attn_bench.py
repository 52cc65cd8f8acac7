"""Microbenchmark the port's attention paths at the MaskDiT training shapes.

Usage: python tools/torch_attn_bench.py [impl ...] [--device cuda]
impls: xla | flash | batched (default: all)

The twin of tools/attn_bench.py: the same SHAPES (the XL/2 @256 encoder
(48, 16, 128, 72) and decoder (48, 16, 256, 32), the XL/2 @512 encoder
(48, 16, 512, 72)), bf16, the forward and the forward + backward (the
gradient of the output's fp32 sum w.r.t. q, k and v), each the mean of 30
calls after one warm-up call, the device synchronised, printed in the JAX
tool's line format. The names map to the port's paths:

  xla      ops/attention.mha_reference (the plain math, PyTorch ops)
  flash    ops/flash.flash_mha (kernels #5 / #6)
  batched  ops/flash_batched.flash_mha_batched (kernels #1 / #2)

Where a kernel refuses a shape it raises; that row is printed as refused,
with the kernel's message, and the run goes on (the JAX package sends
L 512 at 16 heads of 72 to its blocked kernels, flash_batched.py:192-208).
No plain fallback is ever timed under a kernel's name. ``--device``
defaults to cuda; a missing card raises.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

SHAPES = [
    ("enc", (48, 16, 128, 72)),
    ("dec", (48, 16, 256, 32)),
    ("enc512", (48, 16, 512, 72)),
]
IMPLS = ("xla", "batched", "flash")


def impl_fn(name):
    if name == "xla":
        from maskdit_tpu_torch.ops.attention import mha_reference

        return mha_reference
    if name == "flash":
        from maskdit_tpu_torch.ops.flash import flash_mha

        return flash_mha
    if name == "batched":
        from maskdit_tpu_torch.ops.flash_batched import flash_mha_batched

        return flash_mha_batched
    raise SystemExit(f"unknown impl {name}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timeit(f, args, device: torch.device, iters: int = 30) -> float:
    """Mean seconds of ``f(*args)`` over ``iters`` calls after one."""
    out = f(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    _sync(device)
    del out
    return (time.perf_counter() - t0) / iters


def bench(impls, device: torch.device, shapes=SHAPES, iters: int = 30) -> list[dict]:
    """One row per (shape, implementation): fwd and fwd+bwd seconds, or the
    refusal's message."""
    g = torch.Generator(device=device).manual_seed(0)
    rows = []
    for sname, shape in shapes:
        qkv = [torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3)]
        for name in impls:
            fn = impl_fn(name)

            def fwd(q, k, v):
                with torch.no_grad():
                    return fn(q, k, v)

            def grad(q, k, v):
                q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
                return torch.autograd.grad(fn(q, k, v).float().sum(), (q, k, v))

            try:
                t_f = timeit(fwd, qkv, device, iters)
                t_b = timeit(grad, qkv, device, iters)
            except (RuntimeError, ValueError) as err:
                print(f"{sname} {shape} {name:8s}: refused: {err}", flush=True)
                rows.append(dict(shape=sname, impl=name, refused=str(err)))
                continue
            print(
                f"{sname} {shape} {name:8s}: fwd {t_f*1e3:7.3f} ms, "
                f"fwd+bwd {t_b*1e3:7.3f} ms",
                flush=True,
            )
            rows.append(dict(shape=sname, impl=name, fwd_ms=t_f * 1e3, fwd_bwd_ms=t_b * 1e3))
    return rows


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("impls", nargs="*", help="xla | flash | batched (default: all)")
    p.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = p.parse_args(argv)
    return bench(args.impls or list(IMPLS), torch.device(args.device))


if __name__ == "__main__":
    main()
