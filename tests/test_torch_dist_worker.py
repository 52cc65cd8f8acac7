"""One process of the port's multi-process tests on the CPU (gloo).

    python -m torch.distributed.run --nproc_per_node 2 -m tests.test_torch_dist_worker \
        step OUT_DIR OPTIONS_JSON
    python -m tests.test_torch_dist_worker step-alone OUT_DIR OPTIONS_JSON
    python -m torch.distributed.run --nproc_per_node 2 -m tests.test_torch_dist_worker \
        {train,generate,eval_latent,fid} CLI_ARGS...

Shrinks DiT-S/2 to the tiny dims of the tests (``tiny_dit``) and then runs
either data-parallel train steps on this process's rows of a seeded global
batch (``step``: writes its state to ``OUT_DIR/rank<r>.pt``; ``step-alone``
the steps of one process without a group, ``OUT_DIR/alone.pt``), or one of
the port's CLIs. Imports no jax: tests/test_torch_data_parallel.py
imports ``step_run`` for the one-process run it is compared with.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from maskdit_tpu_torch.models import create_model, dit

RES, CIN, K = 8, 4, 6
GLOBAL_BATCH, STEPS = 8, 2


def shrink() -> None:
    """DiT-S/2 at depth 2, width 64, 4 heads, with a 2 x 64 x 4 decoder."""
    dit.DIT_CONFIGS["DiT-S/2"] = dict(depth=2, hidden_size=64, patch_size=2, num_heads=4)
    dit.DECODER_HIDDEN_SIZE, dit.DECODER_DEPTH, dit.DECODER_NUM_HEADS = 64, 2, 4


def global_batch(step: int) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(1000 + step)
    return {
        "x": torch.from_numpy(rng.normal(size=(GLOBAL_BATCH, 2 * CIN, RES, RES))
                              .astype(np.float32)),
        "y": torch.from_numpy(np.eye(K, dtype=np.float32)[rng.integers(0, K, GLOBAL_BATCH)]),
    }


def step_run(options: dict, sync=None) -> dict[str, torch.Tensor]:
    """``STEPS`` train steps of the tiny model (fp32 compute) from seed 0 on
    the global batch, or on this process's rows of it under ``sync``. The
    caller shrinks DiT-S/2 first (``shrink``, or ``patch_tiny_port`` in a
    test process, which undoes it).
    Returns the flat params, EMA, mu and nu (as fp32) and the last loss."""
    from maskdit_tpu_torch.train.state import create_train_state, make_optimizer, make_train_step
    from maskdit_tpu_torch.train.trainer import step_seed

    torch.manual_seed(0)
    model = create_model("edm", img_resolution=RES, img_channels=CIN, num_classes=K,
                         model_type="DiT-S/2", use_decoder=True, mae_loss_coef=0.1,
                         dtype=torch.float32, use_flash=False)
    opt = make_optimizer(1e-3, GLOBAL_BATCH, moment_dtype=options.get("moment_dtype"),
                         nu_dtype=options.get("nu_dtype"))
    state = create_train_state(model, opt)
    train_step = make_train_step(
        opt, mask_ratio=0.5, mae_loss_coef=0.1, ema_decay=0.99,
        grad_accum=options.get("grad_accum", 1), amp_grads=options.get("amp_grads", False),
        accum_dtype=options.get("accum_dtype"), ema_every=options.get("ema_every", 1),
        sync=sync,
    )
    generator = torch.Generator()
    for step in range(STEPS):
        batch = global_batch(step)
        if sync is not None:
            n = GLOBAL_BATCH // sync.world
            batch = {k: v[sync.rank * n:(sync.rank + 1) * n] for k, v in batch.items()}
        generator.manual_seed(step_seed(1, step))
        metrics = train_step(state, batch, generator)
    return {"params": state.params.clone(), "ema": state.ema.clone(),
            "mu": state.opt_state.mu.float(), "nu": state.opt_state.nu.float(),
            "loss": metrics["loss"].clone()}


def main(argv: list[str]) -> None:
    command, args = argv[0], argv[1:]
    shrink()
    if command in ("step", "step-alone"):
        from maskdit_tpu_torch.parallel import dist
        from maskdit_tpu_torch.parallel.data_parallel import data_parallel

        out_dir, options = args[0], json.loads(args[1])
        if command == "step-alone":  # no process group
            torch.save(step_run(options), os.path.join(out_dir, "alone.pt"))
            return
        dist.init_distributed(device="cpu")
        out = step_run(options, data_parallel())
        torch.save(out, os.path.join(out_dir, f"rank{dist.process_index()}.pt"))
        dist.shutdown()
        return
    if command == "train":
        from maskdit_tpu_torch.train.cli import main as run
    elif command == "generate":
        from maskdit_tpu_torch.generate import main as run
    elif command == "eval_latent":
        from maskdit_tpu_torch.eval_latent import main as run
    elif command == "fid":
        from maskdit_tpu_torch.fid import main as run
    else:
        raise SystemExit(f"unknown command {command}")
    run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
