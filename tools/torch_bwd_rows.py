"""The attention backward rows of chip_smoke.py from one checkout, on one GPU.

    python3 tools/torch_bwd_rows.py [CHECKOUT]

CHECKOUT (default: the current directory) is the root of a checkout of
this repository, for example the parent commit unpacked with
``git archive`` into a gitignored directory. The script imports that
checkout's ``chip_smoke`` and ``maskdit_tpu_torch``, so the kernels it
builds (under CHECKOUT/build/kernels) and times are that commit's: the
whole-row backward (kernel #2) at ``chip_smoke.BWD_SHAPES`` and the blocked
backward (#4) at ``chip_smoke.BIG_BWD_SHAPES``, in bf16 and fp32, each
against its plain version with kernel, plain and SDPA times and the bound,
as ``chip_smoke.py`` prints them. Run it on the parent and on the change
in one call to compare the two backwards on one card. Needs CUDA.
"""

from __future__ import annotations

import os
import sys


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.abspath(argv[0] if argv else ".")
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke as smoke
    from maskdit_tpu_torch.ops import build, flash_batched, flash_big

    smoke.phase_device()
    for kernel in (flash_batched.BWD_KERNEL, flash_big.BWD_KERNEL):
        smoke.log(f"[build] {build.build(kernel)[0].name}")
    smoke.phase_bwd_kernels()
    smoke.attention_bwd_rows("kernel-big", smoke.BIG_BWD_SHAPES,
                             flash_big.packed_attention_big_bwd,
                             flash_big.packed_attention_big_bwd_reference, seed=6, iters=5)


if __name__ == "__main__":
    main()
