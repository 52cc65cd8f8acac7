"""The attention kernel rows of chip_smoke.py from one checkout, on one GPU.

    python3 tools/torch_kernel_rows.py [CHECKOUT] [KERNEL ...]

CHECKOUT (default: the current directory) is the root of a checkout of
this repository, for example the parent commit unpacked with
``git archive`` into a gitignored directory. The script imports that
checkout's ``chip_smoke`` and ``maskdit_tpu_torch``, so the kernels it
builds (under CHECKOUT/build/kernels) and times are that commit's. KERNEL
(default: all four) picks the rows, in bf16 and fp32, each against its
plain version with kernel, plain and SDPA times and the bound, as
``chip_smoke.py`` prints them:

  1  the whole-row forward at ``chip_smoke.ATTN_SHAPES``;
  2  the whole-row backward at ``chip_smoke.BWD_SHAPES``;
  4  the blocked backward at ``chip_smoke.BIG_BWD_SHAPES``;
  6  the flash backward at ``chip_smoke.FLASH_BWD_SHAPES``, on the
     checkout's flash forward's residuals.

Run it on the parent and on the change in one call to compare the kernels
on one card. Needs CUDA.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else ".")
    kernels = [int(k) for k in argv[1:]] or [1, 2, 4, 6]
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as smoke
    from maskdit_tpu_torch.ops import build, flash, flash_batched, flash_big

    sources = {1: [flash_batched.KERNEL], 2: [flash_batched.BWD_KERNEL],
               4: [flash_big.BWD_KERNEL], 6: [flash.KERNEL, flash.BWD_KERNEL]}
    smoke.phase_device()
    for k in kernels:
        for name in sources[k]:
            smoke.log(f"[build] {build.build(name)[0].name}")
    if 1 in kernels:
        smoke.attention_fwd_rows("kernel", smoke.ATTN_SHAPES, flash_batched.packed_attention,
                                 flash_batched.packed_attention_reference, seed=0, iters=50,
                                 variant=flash_batched.fwd_kernel)
    if 2 in kernels:
        smoke.phase_bwd_kernels()
    if 4 in kernels:
        smoke.attention_bwd_rows("kernel-big", smoke.BIG_BWD_SHAPES,
                                 flash_big.packed_attention_big_bwd,
                                 flash_big.packed_attention_big_bwd_reference, seed=6, iters=5,
                                 variant=smoke.blocked_variant)
    if 6 in kernels:
        g = torch.Generator(device="cuda").manual_seed(7)
        for name, n, l, h, hd in smoke.FLASH_BWD_SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                smoke.flash_bwd_row(name, n, l, h, hd, dtype, g, 5)
                smoke.free_device_memory()


if __name__ == "__main__":
    main()
