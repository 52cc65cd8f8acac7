"""Time the PyTorch port's sampling in two checkouts, in one call.

    python3 tools/torch_ab_sampling.py [--res 256|512] BEFORE_DIR AFTER_DIR [ROUNDS]

Each directory is the root of a checkout of this repository (for example
the parent commit unpacked with ``git archive`` into a gitignored
directory, and the working tree). ROUNDS (default 1) rounds of four turns
run in the order before, after, after, before, each in a fresh process
with its checkout first on ``sys.path``, on one NVIDIA GPU. A turn builds
DiT-XL/2 (decoder, 1000 classes, bf16, every parameter ~ N(0, 0.02^2) from
seed 0) at ``--res`` px: 256 (sample256: 32 x 32 latents, batch 8, the
whole-row attention kernel) or 512 (sample512: the model of
configs/test/maskdit-512.yaml, 64 x 64 latents, batch 4, the blocked
attention kernel). It warms up with one batch, then measures:

  * images/s of ``generate_with_params``: a batch of seeds, 40 EDM steps,
    CFG 1.5 (79 denoiser evaluations), twice, host clock, synchronised;
  * wall ms of one CFG denoiser evaluation (the batch x 2), mean of 20,
    unprofiled, and the process's CPU ms over the same 20 (the host's
    work, which other tenants of the machine's cores inflate less than
    the wall time);
  * device busy ms of one evaluation from torch.profiler (mean of 3) and
    the idle share 1 - busy / wall;
  * launches of the resolution's attention kernel per evaluation (36).

Each turn prints one JSON line; then the median of each number per
checkout; the last line is the card's name and power limit. Uses only
what both checkouts have: ``models.create_model``, ``sampling.generate``,
``ops.flash_batched.packed_attention.launches`` and
``ops.flash_big.packed_attention_big.launches``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STEPS, CFG = 40, 1.5
# seeds (the batch) per resolution: sample256 and sample512
SEEDS = {256: 8, 512: 4}


def turn(root: str, res: int) -> dict:
    """One measurement in this process, of the checkout at ``root``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maskdit_tpu_torch.models import create_model
    from maskdit_tpu_torch.ops import flash_batched, flash_big
    from maskdit_tpu_torch.sampling.generate import SamplerConfig, generate_with_params

    assert os.path.abspath(flash_batched.__file__).startswith(os.path.abspath(root))
    seeds, latent = SEEDS[res], res // 8
    kernel = flash_batched.packed_attention if res == 256 else flash_big.packed_attention_big
    torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model("edm", img_resolution=latent, img_channels=4, num_classes=1000,
                         model_type="DiT-XL/2", use_decoder=True, mae_loss_coef=0.1,
                         dtype=torch.bfloat16).cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=g)
    cfg = SamplerConfig(num_steps=STEPS, cfg_scale=CFG)

    def sample() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_with_params(model, list(range(seeds)), None, cfg, max_batch_size=seeds)
        torch.cuda.synchronize()
        return seeds / (time.perf_counter() - t0)

    sample()  # warm-up: kernel build and load, cuBLAS handles
    images_per_s = [sample(), sample()]

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(seeds, 4, latent, latent)).astype(np.float32)).cuda()
    sigma = torch.from_numpy(rng.uniform(0.5, 5.0, size=seeds).astype(np.float32)).cuda()
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 1000, size=seeds)), 1000).float().cuda()

    def evaluate() -> None:
        with torch.no_grad():
            model(x, sigma, y, cfg_scale=CFG)

    evaluate()
    torch.cuda.synchronize()
    before = kernel.launches
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(20):
        evaluate()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    cpu_ms = (time.process_time() - c0) / 20 * 1e3
    launches = (kernel.launches - before) / 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            evaluate()
        torch.cuda.synchronize()
    # kernels, copies and sets; not the kernels' launch ranges ("maskdit::<entry>",
    # ops/build.launch_range where the checkout has them), which span kernels
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not e.key.startswith("maskdit::")) / 3 / 1e3
    return {"root": root, "res": res, "images_per_s": images_per_s, "eval_wall_ms": wall_ms,
            "eval_host_cpu_ms": cpu_ms,
            "eval_busy_ms": busy_ms, "idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "attention_launches_per_eval": launches}


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--turn":
        print(json.dumps(turn(os.path.abspath(argv[1]), int(argv[2]))), flush=True)
        return 0
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--res", type=int, choices=sorted(SEEDS), default=256)
    parser.add_argument("before")
    parser.add_argument("after")
    parser.add_argument("rounds", type=int, nargs="?", default=1)
    args = parser.parse_args(argv)
    before, after = os.path.abspath(args.before), os.path.abspath(args.after)
    results = []
    order = [("before", before), ("after", after), ("after", after), ("before", before)]
    for label, root in order * args.rounds:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root,
                              str(args.res)],
                             cwd=root, capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        row["label"] = label
        results.append(row)
        print(json.dumps(row), flush=True)
    for label in ("before", "after"):
        rows = [r for r in results if r["label"] == label]
        print(json.dumps({"label": label, "turns": len(rows), "median": {
            "images_per_s": statistics.median(x for r in rows for x in r["images_per_s"]),
            **{k: statistics.median(r[k] for r in rows)
               for k in ("eval_wall_ms", "eval_host_cpu_ms", "eval_busy_ms", "idle_share")},
        }}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
