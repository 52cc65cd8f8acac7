"""The attention route (models/layers.attention_route) at every point of a
grid, frozen.

Grid: heads 2, 4, 16; L 64, 128, ..., 4096 and 77, 240, 777 (in increasing
order, one character each in the strings below); head dims 8, 16, ..., 128;
with and without a backward; ``use_flash`` None, True, False. Characters:
w 'packed' (kernels #1 / #2), b 'big' (#3 / #4), f 'flash' (#5 / #6), p
'plain', x NotImplementedError. Keys: heads/hd/(b)ackward or (f)orward
only/use_flash (auto None, flash True, plain False).

When the fp32 paths of the whole-row kernels moved to the tensor cores
(their shared memory and the blocked kernels' no longer grow with L), the
route took each package's kernels wherever the JAX package's window for
them holds (``flash_batched.supports``, ``flash_big.supports``: copies of
the JAX ``supports`` and ``_plan``) and they launch. 342 points moved, each
from its old route to the JAX package's choice there (``jax_choice`` of
tests/test_torch_512.py); ``use_flash`` True and False moved nowhere. As
"old -> new [heads and pass: 2b = 2 heads with a backward, 2f forward
only] hd: L ...":
  * flash -> big [2b, 2f, 4b, 4f, 16b, 16f] hd: L 8: 1792 2048; 16: 1792
    2048; 24: 1792 2048; 32: 1792 2048; 40: 1792 2048; 48: 1536 1792; 56:
    1536 1792; 64: 1536; 72: 1536; 80: 1536; 88: 1280 1536; 96: 1280; 104:
    1280; 112: 1280; 120: 1280; 128: 1280
  * plain -> big [2b, 2f, 4b, 4f, 16b, 16f] hd: L 8: 2304 2560; 16: 2304;
    24: 2304
  * big -> packed [2b] hd: L 8: 768; 16: 640 768; 24: 512 640 768; 32: 512
    768; 40: 384 512 768; 48: 384 512 768; 56: 384 512; 64: 512; 72: 256
    512; 80: 256 512; 88: 256 512; 96: 512; 104: 512; 112: 512; 120: 512;
    128: 512
  * big -> packed [2f] hd: L 24: 768; 32: 768; 40: 512 768; 48: 512 768; 56:
    512; 64: 512; 72: 512; 80: 512; 88: 512; 96: 512; 104: 512; 112: 512;
    120: 512; 128: 512
  * big -> packed [4b] hd: L 8: 768; 16: 640 768; 24: 512 640 768; 32: 512;
    40: 384 512; 48: 384 512; 56: 384 512; 64: 512; 72: 256 512; 80: 256
    512; 88: 256 512; 96: 512; 104: 512; 112: 512; 120: 512
  * big -> packed [4f] hd: L 24: 768; 40: 512; 48: 512; 56: 512; 64: 512;
    72: 512; 80: 512; 88: 512; 96: 512; 104: 512; 112: 512; 120: 512
  * big -> packed [16b] hd: L 16: 640; 24: 512; 40: 384; 48: 384; 72: 256;
    80: 256
  * plain -> packed [2b, 2f] hd: L 32: 640; 40: 640; 48: 640; 56: 640; 64:
    384 640; 72: 384 640; 80: 384 640; 88: 384 640; 96: 256 384 640; 104:
    256 384 640; 112: 256 384 640; 120: 256 384; 128: 256 384
  * plain -> packed [4b, 4f] hd: L 32: 640; 40: 640; 48: 640; 56: 640; 64:
    384 640; 72: 384; 80: 384; 88: 384; 96: 256 384; 104: 256 384; 112: 256
    384; 120: 256 384; 128: 256 384
"""

import pytest

from maskdit_tpu_torch.models.layers import attention_route

LENGTHS = sorted([77, 240, 777] + list(range(64, 4097, 64)))
CODES = {"plain": "p", "flash": "f", "packed": "w", "big": "b"}
FLAGS = {"auto": None, "flash": True, "plain": False}

ROUTES = {
    "wwwwwwwwwwwwwwwwwwwwwpbpfpbpfpbpfpbpppbpppbpppppppppppppppppppppppp": (
        "2/8/f/auto 4/8/f/auto 16/8/f/auto "
    ),
    "ppfppfpfpfpfpfppfpfpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/8/f/flash 2/8/b/flash 2/16/f/flash 2/16/b/flash 2/24/f/flash 2/24/b/flash "
        "2/32/f/flash 2/32/b/flash 2/40/f/flash 2/40/b/flash 2/48/f/flash 2/48/b/flash "
        "2/56/f/flash 2/56/b/flash 2/64/f/flash 2/64/b/flash 2/72/f/flash 2/72/b/flash "
        "2/80/f/flash 2/80/b/flash 2/88/f/flash 2/88/b/flash 2/96/f/flash 2/96/b/flash "
        "2/104/f/flash 2/104/b/flash 2/112/f/flash 2/112/b/flash 2/120/f/flash 2/120/b/flash "
        "2/128/f/flash 2/128/b/flash 4/8/f/flash 4/8/b/flash 4/16/f/flash 4/16/b/flash "
        "4/24/f/flash 4/24/b/flash 4/32/f/flash 4/32/b/flash 4/40/f/flash 4/40/b/flash "
        "4/48/f/flash 4/48/b/flash 4/56/f/flash 4/56/b/flash 4/64/f/flash 4/64/b/flash "
        "4/72/f/flash 4/72/b/flash 4/80/f/flash 4/80/b/flash 4/88/f/flash 4/88/b/flash "
        "4/96/f/flash 4/96/b/flash 4/104/f/flash 4/104/b/flash 4/112/f/flash 4/112/b/flash "
        "4/120/f/flash 4/120/b/flash 4/128/f/flash 4/128/b/flash 16/8/f/flash 16/8/b/flash "
        "16/16/f/flash 16/16/b/flash 16/24/f/flash 16/24/b/flash 16/32/f/flash 16/32/b/flash "
        "16/40/f/flash 16/40/b/flash 16/48/f/flash 16/48/b/flash 16/56/f/flash 16/56/b/flash "
        "16/64/f/flash 16/64/b/flash 16/72/f/flash 16/72/b/flash 16/80/f/flash 16/80/b/flash "
        "16/88/f/flash 16/88/b/flash 16/96/f/flash 16/96/b/flash 16/104/f/flash "
        "16/104/b/flash 16/112/f/flash 16/112/b/flash 16/120/f/flash 16/120/b/flash "
        "16/128/f/flash 16/128/b/flash "
    ),
    "ppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppp": (
        "2/8/f/plain 2/8/b/plain 2/16/f/plain 2/16/b/plain 2/24/f/plain 2/24/b/plain "
        "2/32/f/plain 2/32/b/plain 2/40/f/plain 2/40/b/plain 2/48/f/plain 2/48/b/plain "
        "2/56/f/plain 2/56/b/plain 2/64/f/plain 2/64/b/plain 2/72/f/plain 2/72/b/plain "
        "2/80/f/plain 2/80/b/plain 2/88/f/plain 2/88/b/plain 2/96/f/plain 2/96/b/plain "
        "2/104/f/plain 2/104/b/plain 2/112/f/plain 2/112/b/plain 2/120/f/plain 2/120/b/plain "
        "2/128/f/plain 2/128/b/plain 4/8/f/plain 4/8/b/plain 4/16/f/plain 4/16/b/plain "
        "4/24/f/plain 4/24/b/plain 4/32/f/plain 4/32/b/plain 4/40/f/plain 4/40/b/plain "
        "4/48/f/plain 4/48/b/plain 4/56/f/plain 4/56/b/plain 4/64/f/plain 4/64/b/plain "
        "4/72/f/plain 4/72/b/plain 4/80/f/plain 4/80/b/plain 4/88/f/plain 4/88/b/plain "
        "4/96/f/plain 4/96/b/plain 4/104/f/plain 4/104/b/plain 4/112/f/plain 4/112/b/plain "
        "4/120/f/plain 4/120/b/plain 4/128/f/plain 4/128/b/plain 16/8/f/plain 16/8/b/plain "
        "16/16/f/plain 16/16/b/plain 16/24/f/plain 16/24/b/plain 16/32/f/plain 16/32/b/plain "
        "16/40/f/plain 16/40/b/plain 16/48/f/plain 16/48/b/plain 16/56/f/plain 16/56/b/plain "
        "16/64/f/plain 16/64/b/plain 16/72/f/plain 16/72/b/plain 16/80/f/plain 16/80/b/plain "
        "16/88/f/plain 16/88/b/plain 16/96/f/plain 16/96/b/plain 16/104/f/plain "
        "16/104/b/plain 16/112/f/plain 16/112/b/plain 16/120/f/plain 16/120/b/plain "
        "16/128/f/plain 16/128/b/plain "
    ),
    "wwwwwwwwwwwwbwbbbbbbbpbpfpbpfpbpfpbpppbpppbpppppppppppppppppppppppp": (
        "2/8/b/auto 4/8/b/auto "
    ),
    "wwwwwwwwwwwwwwwwppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "2/16/f/auto 4/16/f/auto 16/16/f/auto "
    ),
    "wwwwwwwwwwbwbwbbppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "2/16/b/auto 4/16/b/auto "
    ),
    "wwwwwwwwwwwwwwppppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "2/24/f/auto 4/24/f/auto "
    ),
    "wwwwwwwwwwbwbwppppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "2/24/b/auto 4/24/b/auto "
    ),
    "wwwwwwwwwwwwpwppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "2/32/f/auto "
    ),
    "wwwwwwwwbwbwpwppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "2/32/b/auto "
    ),
    "wwwwwwwwwwpwpwppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "2/40/f/auto "
    ),
    "wwwwwwwwbwpwpwppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "2/40/b/auto "
    ),
    "wwwwwwwwpwpwpwppppbpfpbpfpbpfpbpfpfpppppppppppppppppppppppppppppppp": (
        "2/48/f/auto 2/48/b/auto "
    ),
    "wwwwwwwwpwpwpbppppbpfpbpfpbpfpbpfpfpppppppppppppppppppppppppppppppp": (
        "2/56/f/auto 4/48/f/auto 4/48/b/auto 4/56/f/auto "
    ),
    "wwwwwwbwpwpwpbppppbpfpbpfpbpfpbpfpfpppppppppppppppppppppppppppppppp": (
        "2/56/b/auto 4/56/b/auto "
    ),
    "wwwwwwwwpwpwpbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/64/f/auto 4/64/f/auto "
    ),
    "wwwwwwbwpwpwpbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/64/b/auto 4/64/b/auto "
    ),
    "wwwwwwpwpwpwpbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/72/f/auto 2/80/f/auto 2/88/f/auto "
    ),
    "wwwwbwpwpwpwpbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/72/b/auto 2/80/b/auto 2/88/b/auto "
    ),
    "wwwwpwpwpwpwpbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/96/f/auto 2/96/b/auto 2/104/f/auto 2/112/f/auto "
    ),
    "wwwbpwpwpwpwpbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/104/b/auto 2/112/b/auto "
    ),
    "wwwwpwpwpwpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/120/f/auto 4/96/f/auto 4/96/b/auto 4/104/f/auto 4/112/f/auto 4/120/f/auto "
    ),
    "wwwbpwpwpwpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/120/b/auto 4/104/b/auto 4/112/b/auto 4/120/b/auto "
    ),
    "wwwppwpwpwpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/128/f/auto 2/128/b/auto "
    ),
    "wwwwwwwwwwwwpbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "4/32/f/auto "
    ),
    "wwwwwwwwbwbwpbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "4/32/b/auto "
    ),
    "wwwwwwwwwwpwpbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "4/40/f/auto "
    ),
    "wwwwwwwwbwpwpbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "4/40/b/auto "
    ),
    "wwwwwwpwpwpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "4/72/f/auto 4/80/f/auto 4/88/f/auto "
    ),
    "wwwwbwpwpwpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "4/72/b/auto 4/80/b/auto 4/88/b/auto "
    ),
    "wwwppwpwpbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "4/128/f/auto 4/128/b/auto "
    ),
    "wwwwwwwwwwwwbbbbbbbbbpbpfpbpfpbpfpbpppbpppbpppppppppppppppppppppppp": (
        "16/8/b/auto "
    ),
    "wwwwwwwwwwbwbbbbppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "16/16/b/auto "
    ),
    "wwwwwwwwwwwwwbppppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "16/24/f/auto "
    ),
    "wwwwwwwwwwbbbbppppbpfpbpfpbpfpbpfpbpppbpppppppppppppppppppppppppppp": (
        "16/24/b/auto "
    ),
    "wwwwwwwwwwwppbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "16/32/f/auto "
    ),
    "wwwwwwwwbbbppbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "16/32/b/auto "
    ),
    "wwwwwwwwwbpppbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "16/40/f/auto "
    ),
    "wwwwwwwwbbpppbppppbpfpbpfpbpfpbpfpbpppppppppppppppppppppppppppppppp": (
        "16/40/b/auto "
    ),
    "wwwwwwwwpbpppbppppbpfpbpfpbpfpbpfpfpppppppppppppppppppppppppppppppp": (
        "16/48/f/auto 16/48/b/auto 16/56/f/auto "
    ),
    "wwwwwwbbpbpppbppppbpfpbpfpbpfpbpfpfpppppppppppppppppppppppppppppppp": (
        "16/56/b/auto "
    ),
    "wwwwwwwppbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/64/f/auto "
    ),
    "wwwwwwbppbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/64/b/auto "
    ),
    "wwwwwwpppbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/72/f/auto 16/80/f/auto 16/88/f/auto "
    ),
    "wwwwbwpppbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/72/b/auto 16/80/b/auto "
    ),
    "wwwwbbpppbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/88/b/auto "
    ),
    "wwwwpppppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/96/f/auto 16/96/b/auto 16/104/f/auto 16/112/f/auto 16/120/f/auto "
    ),
    "wwwbpppppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/104/b/auto 16/112/b/auto 16/120/b/auto "
    ),
    "wwwppppppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "16/128/f/auto 16/128/b/auto "
    ),
}


def _expected() -> dict:
    table = {}
    for routes, keys in ROUTES.items():
        for key in keys.split():
            heads, hd, pass_, flag = key.split("/")
            table[(int(heads), int(hd), pass_ == "b", FLAGS[flag])] = routes
    return table


EXPECTED = _expected()


def _route(h: int, l: int, hd: int, backward: bool, use_flash) -> str:
    try:
        return CODES[attention_route(h, l, hd, backward, use_flash)]
    except NotImplementedError:
        return "x"


def test_the_table_covers_the_grid():
    assert len(EXPECTED) == 3 * 16 * 2 * 3
    assert all(len(v) == len(LENGTHS) for v in EXPECTED.values())


@pytest.mark.parametrize("use_flash", [None, True, False], ids=["auto", "flash", "plain"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("heads", [2, 4, 16])
def test_route_answers_as_frozen(heads, backward, use_flash):
    for hd in range(8, 129, 8):
        got = "".join(_route(heads, l, hd, backward, use_flash) for l in LENGTHS)
        assert got == EXPECTED[(heads, hd, backward, use_flash)], (heads, hd, backward, use_flash)


@pytest.mark.parametrize("heads", [2, 4, 16])
def test_packed_routes_launch_in_both_types(heads):
    """Wherever the route takes 'packed' the whole-row kernels launch in
    both input types (``fits``), and the backward (where one is taken) and
    the fp32 forward run on the tensor cores ('mma' / 'mma6'). So does the
    bf16 forward, but at hd 8 and 16 past L 832, where its logits row
    outgrows a block and its FMA kernel runs."""
    import torch

    from maskdit_tpu_torch.ops import flash_batched

    for hd in range(8, 129, 8):
        for backward in (False, True):
            for l in LENGTHS:
                if attention_route(heads, l, hd, backward) != "packed":
                    continue
                assert flash_batched.fits(l, hd, backward), (l, hd, backward)
                assert flash_batched.fwd_kernel(torch.float32, l, hd) == "mma6"
                corner = hd in (8, 16) and l > 832
                assert flash_batched.fwd_kernel(torch.bfloat16, l, hd) == (
                    "fma" if corner else "mma"), (l, hd)
                if backward:
                    assert flash_batched.bwd_kernel(torch.bfloat16, hd) == "mma"
                    assert flash_batched.bwd_kernel(torch.float32, hd) == "mma6"
