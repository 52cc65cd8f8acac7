"""The attention kernel rows of chip_smoke.py, and its finetune512-flash
path, on one checkout's kernels, on one GPU.

    python3 tools/torch_kernel_rows.py [CHECKOUT] [ITEM ...]

CHECKOUT (default: the current directory) is the root of a checkout of
this repository, for example the parent commit unpacked with
``git archive`` into a gitignored directory. The script imports that
checkout's ``maskdit_tpu_torch`` (so the kernels it builds, under
CHECKOUT/build/kernels, and times are that commit's) and this repository's
``chip_smoke.py`` (so every checkout runs the same rows and phase code).
ITEM (default: 1-6) picks what runs, each row in bf16 and fp32 against its
plain version with kernel, plain and SDPA times and the bound, as
``chip_smoke.py`` prints them:

  1  the whole-row forward at ``chip_smoke.ATTN_SHAPES``;
  2  the whole-row backward at ``chip_smoke.BWD_SHAPES``;
  3  the blocked forward at ``chip_smoke.BIG_FWD_SHAPES``;
  4  the blocked backward at ``chip_smoke.BIG_BWD_SHAPES``;
  5  the flash forward at ``chip_smoke.FLASH_SHAPES``, and in fp32 at
     ``chip_smoke.FLASH_FP32_SHAPES``;
  6  the flash backward at ``chip_smoke.FLASH_BWD_SHAPES`` and
     ``FLASH_FP32_SHAPES``, on the checkout's flash forward's residuals;
  fp32
     ``chip_smoke.phase_fp32_kernels``: #1-#4 in fp32 at the finetunes'
     shapes, at the class token's lengths and over the head dims;
  mesh
     #1 / #2 in fp32 at ``MESH_SHAPES``' 256-px shapes, #3 / #4 and #5 / #6
     at its 512-px ones: one rank's attention in ``[parity-mesh]`` (8 of
     the 16 heads at tensor 2, the case's rows per (data, fsdp)
     coordinate);
  finetune512-flash
     ``[train-finetune512-flash]``: the 512-px finetune with
     ``model.use_flash=true`` through the checkout's train CLI, at full
     width and depth, from random weights (``phase_weights``) on 32 random
     latent records in 4 WebDataset shards (what ``[extract]`` writes in
     ``chip_smoke.py``).

A checkout whose ops/flash.py has no ``fwd_kernel`` runs its fp32 flash
kernels on FMAs: its flash rows are named by type ('mma' in bf16, 'fma' in
fp32) and not held to the tensor cores. Run it on the parent and on the
change in one call to compare them on one card. Needs CUDA.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("1", "2", "3", "4", "5", "6")
# [parity-mesh]'s per-rank attention (fp32, tensor 2): 256 px at batch 8 over
# two (data, fsdp) coordinates, 512 px at batch 4
MESH_SHAPES = {"256": [("mesh_parity_encoder", 4, 128, 8, 72),
                       ("mesh_parity_decoder", 4, 256, 8, 32)],
               "512": [("mesh_parity_512_encoder", 2, 512, 8, 72),
                       ("mesh_parity_512_decoder", 2, 1024, 8, 32)]}


def load_smoke():
    """This repository's chip_smoke.py as the module ``chip_smoke``."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module
    spec.loader.exec_module(module)
    return module


def write_shards(smoke) -> None:
    """32 N(0, 1) latent records (moments of 4 channels at 64 x 64) with
    labels 0-7, in shards of 8, where the 512-px configs read them."""
    import numpy as np

    from maskdit_tpu_torch.data.wds import write_wds_shards

    rng = np.random.default_rng(0)
    write_wds_shards(((f"{i:07d}", rng.normal(size=(8, 64, 64)).astype(np.float32), i % 8)
                      for i in range(32)), smoke.TRAIN_DATA_ROOT_512, maxcount=8)


def flash_rows(smoke, flash, key: str) -> None:
    import torch

    row = smoke.flash_fwd_row if key == "5" else smoke.flash_bwd_row
    shapes = smoke.FLASH_SHAPES if key == "5" else smoke.FLASH_BWD_SHAPES
    # a checkout without flash.fwd_kernel: bf16 on mma.sync, fp32 on FMAs
    named = hasattr(flash, "fwd_kernel")
    g = torch.Generator(device="cuda").manual_seed(7)
    for name, n, l, h, hd in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            variant = None if named else {torch.bfloat16: "mma", torch.float32: "fma"}[dtype]
            row(name, n, l, h, hd, dtype, g, 10 if key == "5" else 5, variant)
            smoke.free_device_memory()
    for name, n, l, h, hd in smoke.FLASH_FP32_SHAPES:
        row(name, n, l, h, hd, torch.float32, g, 5 if key == "5" else 3, None if named else "fma")
        smoke.free_device_memory()


def mesh_rows(smoke, flash, flash_batched, flash_big) -> None:
    import torch

    fp32 = (torch.float32,)
    smoke.attention_fwd_rows("kernel-mesh", MESH_SHAPES["256"], flash_batched.packed_attention,
                             flash_batched.packed_attention_reference, seed=8, iters=50,
                             variant=flash_batched.fwd_kernel, dtypes=fp32)
    smoke.attention_bwd_rows("kernel-mesh", MESH_SHAPES["256"],
                             flash_batched.packed_attention_bwd,
                             flash_batched.packed_attention_bwd_reference, seed=9, iters=20,
                             dtypes=fp32)
    smoke.attention_fwd_rows("kernel-mesh", MESH_SHAPES["512"], flash_big.packed_attention_big,
                             flash_big.packed_attention_big_reference, seed=10, iters=20,
                             variant=smoke.blocked_variant, dtypes=fp32)
    smoke.attention_bwd_rows("kernel-mesh", MESH_SHAPES["512"],
                             flash_big.packed_attention_big_bwd,
                             flash_big.packed_attention_big_bwd_reference, seed=11, iters=10,
                             dtypes=fp32, variant=smoke.blocked_variant)
    g = torch.Generator(device="cuda").manual_seed(12)
    for name, n, l, h, hd in MESH_SHAPES["512"]:
        smoke.flash_fwd_row(name, n, l, h, hd, torch.float32, g, 10)
        smoke.flash_bwd_row(name, n, l, h, hd, torch.float32, g, 5)
        smoke.free_device_memory()


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else ".")
    items = argv[1:] or list(ROWS)
    unknown = set(items) - {*ROWS, "fp32", "mesh", "finetune512-flash"}
    if unknown:
        raise SystemExit(f"torch_kernel_rows: unknown items {sorted(unknown)}")
    os.chdir(root)
    sys.path.insert(0, root)
    smoke = load_smoke()
    from maskdit_tpu_torch.ops import flash, flash_batched, flash_big

    smoke.log(f"[rows] chip_smoke.py from {HERE}, maskdit_tpu_torch from "
              f"{os.path.dirname(flash.__file__)}")
    smoke.phase_device()
    smoke.phase_build()
    for item in items:
        if item == "1":
            smoke.attention_fwd_rows("kernel", smoke.ATTN_SHAPES, flash_batched.packed_attention,
                                     flash_batched.packed_attention_reference, seed=0, iters=50,
                                     variant=flash_batched.fwd_kernel)
        elif item == "2":
            smoke.phase_bwd_kernels()
        elif item == "3":
            smoke.attention_fwd_rows("kernel-big", smoke.BIG_FWD_SHAPES,
                                     flash_big.packed_attention_big,
                                     flash_big.packed_attention_big_reference, seed=5, iters=10,
                                     variant=smoke.blocked_variant)
        elif item == "4":
            smoke.attention_bwd_rows("kernel-big", smoke.BIG_BWD_SHAPES,
                                     flash_big.packed_attention_big_bwd,
                                     flash_big.packed_attention_big_bwd_reference, seed=6, iters=5,
                                     variant=smoke.blocked_variant)
        elif item in ("5", "6"):
            flash_rows(smoke, flash, item)
        elif item == "fp32":
            smoke.phase_fp32_kernels()
        elif item == "mesh":
            mesh_rows(smoke, flash, flash_batched, flash_big)
        else:
            os.makedirs(smoke.SCRATCH, exist_ok=True)
            try:
                smoke.phase_weights()
                write_shards(smoke)
                smoke.phase_finetune("train-finetune512-flash", "512-latent",
                                     smoke.FINETUNE_FLASH_OVERRIDES)
            finally:
                import shutil

                shutil.rmtree(smoke.SCRATCH, ignore_errors=True)


if __name__ == "__main__":
    main()
