"""The attention route under gradient accumulation at 256 px, on one GPU.

    python3 tools/torch_accum_route.py [STEPS]

``default_use_flash`` (maskdit_tpu_torch/train/trainer.py) keeps the JAX
trainer's rule: a config that accumulates gradients at L < 512 trains on
the plain attention. This times the port's train CLI on the released
256-px config (DiT-XL/2, mask 0.5, bf16; synthetic moments, so no data
is needed) at one micro-batch of 64 in three runs of STEPS steps (default
8; the first logged window of 2 steps is warm-up):

  plain-accum2    grad_accum 2, ``model.use_flash`` absent: the rule's
                  plain route;
  kernels-accum1  grad_accum 1, ``model.use_flash`` absent (auto): the
                  packed kernels #1 and #2 at the same micro-batch;
  kernels-accum2  grad_accum 2, ``model.use_flash=null``: the kernels
                  under accumulation.

and prints ms per step and per micro-batch, images/s and peak memory of
each, and the ratio of the plain route's time per micro-batch to the
kernels'. The checkpoints are not written. Needs CUDA and the kernels'
toolchain.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MICRO = 64


def main(argv: list[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if argv else 8
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    smoke.phase_device()
    smoke.phase_build()
    config = json.loads(json.dumps(smoke.TRAIN_CONFIG))
    config["data"] = {"dataset": "imagenet256-latent", "category": "synthetic",
                      "resolution": 32, "num_channels": 4, "length": 4 * MICRO}
    attn = smoke.ATTN_PER_STEP
    runs = {
        "plain-accum2": (2, (), dict(adam=1)),
        "kernels-accum1": (1, (), dict(packed_fwd=attn, packed_bwd=attn, adam=1)),
        "kernels-accum2": (2, ("model.use_flash=null",),
                           dict(packed_fwd=2 * attn, packed_bwd=2 * attn, adam=1)),
    }
    out = {}
    for tag, (accum, extra, per_step) in runs.items():
        r = smoke.run_train(tag, config, 32, per_step, (
            f"train.batchsize={MICRO}", f"train.grad_accum={accum}",
            f"train.max_num_steps={steps}", *extra), write_checkpoints=False)
        out[tag] = dict(ms_per_step=r["ms_per_step"], ms_per_micro=r["ms_per_step"] / accum,
                        images_per_s=r["images_per_s"], peak_gib=r["peak_gib"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    ratio = out["plain-accum2"]["ms_per_micro"] / out["kernels-accum1"]["ms_per_micro"]
    print(f"[accum-route] {smi}: micro-batch {MICRO}, {steps} steps each; "
          + "; ".join(f"{k} {v['ms_per_step']:.1f} ms/step ({v['ms_per_micro']:.1f} ms per "
                      f"micro-batch), {v['images_per_s']:.2f} images/s, peak "
                      f"{v['peak_gib']:.2f} GiB" for k, v in out.items())
          + f"; plain route / kernels per micro-batch {ratio:.3f}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
