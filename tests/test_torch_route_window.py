"""The attention route (models/layers.attention_route) at every point of a
grid, frozen from its answers before the fp32 blocked kernels moved to the
tensor cores (their shared memory stopped growing with L; the route keeps
``flash_big.route_window``, so no shape changes kernel).

Grid: heads 2, 4, 16; L 64, 128, ..., 4096 and 77, 240, 777 (in increasing
order, one character each in the strings below); head dims 8, 16, ..., 128;
with and without a backward; ``use_flash`` None, True, False. Characters:
w 'packed' (kernels #1 / #2), b 'big' (#3 / #4), f 'flash' (#5 / #6), p
'plain', x NotImplementedError. Keys: heads/hd/(b)ackward or (f)orward
only/use_flash (auto None, flash True, plain False).
"""

import pytest

from maskdit_tpu_torch.models.layers import attention_route

LENGTHS = sorted([77, 240, 777] + list(range(64, 4097, 64)))
CODES = {"plain": "p", "flash": "f", "packed": "w", "big": "b"}
FLAGS = {"auto": None, "flash": True, "plain": False}

ROUTES = {
    "wwwwwwwwwwwwwwwwwwwwwpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/8/f/auto 4/8/f/auto 16/8/f/auto "
    ),
    "ppfppfpfpfpfpfppfpfpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/8/f/flash 2/8/b/flash 2/16/f/flash 2/16/b/flash 2/24/f/flash 2/24/b/flash "
        "2/32/f/flash 2/32/b/flash 2/40/f/flash 2/40/b/flash 2/48/f/flash 2/48/b/flash "
        "2/56/f/flash 2/56/b/flash 2/64/f/flash 2/64/b/flash 2/72/f/flash 2/72/b/flash "
        "2/80/f/flash 2/80/b/flash 2/88/f/flash 2/88/b/flash 2/96/f/flash 2/96/b/flash "
        "2/104/f/flash 2/104/b/flash 2/112/f/flash 2/112/b/flash 2/120/f/flash "
        "2/120/b/flash 2/128/f/flash 2/128/b/flash 4/8/f/flash 4/8/b/flash 4/16/f/flash "
        "4/16/b/flash 4/24/f/flash 4/24/b/flash 4/32/f/flash 4/32/b/flash 4/40/f/flash "
        "4/40/b/flash 4/48/f/flash 4/48/b/flash 4/56/f/flash 4/56/b/flash 4/64/f/flash "
        "4/64/b/flash 4/72/f/flash 4/72/b/flash 4/80/f/flash 4/80/b/flash 4/88/f/flash "
        "4/88/b/flash 4/96/f/flash 4/96/b/flash 4/104/f/flash 4/104/b/flash "
        "4/112/f/flash 4/112/b/flash 4/120/f/flash 4/120/b/flash 4/128/f/flash "
        "4/128/b/flash 16/8/f/flash 16/8/b/flash 16/16/f/flash 16/16/b/flash "
        "16/24/f/flash 16/24/b/flash 16/32/f/flash 16/32/b/flash 16/40/f/flash "
        "16/40/b/flash 16/48/f/flash 16/48/b/flash 16/56/f/flash 16/56/b/flash "
        "16/64/f/flash 16/64/b/flash 16/72/f/flash 16/72/b/flash 16/80/f/flash "
        "16/80/b/flash 16/88/f/flash 16/88/b/flash 16/96/f/flash 16/96/b/flash "
        "16/104/f/flash 16/104/b/flash 16/112/f/flash 16/112/b/flash 16/120/f/flash "
        "16/120/b/flash 16/128/f/flash 16/128/b/flash "
    ),
    "ppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppppp": (
        "2/8/f/plain 2/8/b/plain 2/16/f/plain 2/16/b/plain 2/24/f/plain 2/24/b/plain "
        "2/32/f/plain 2/32/b/plain 2/40/f/plain 2/40/b/plain 2/48/f/plain 2/48/b/plain "
        "2/56/f/plain 2/56/b/plain 2/64/f/plain 2/64/b/plain 2/72/f/plain 2/72/b/plain "
        "2/80/f/plain 2/80/b/plain 2/88/f/plain 2/88/b/plain 2/96/f/plain 2/96/b/plain "
        "2/104/f/plain 2/104/b/plain 2/112/f/plain 2/112/b/plain 2/120/f/plain "
        "2/120/b/plain 2/128/f/plain 2/128/b/plain 4/8/f/plain 4/8/b/plain 4/16/f/plain "
        "4/16/b/plain 4/24/f/plain 4/24/b/plain 4/32/f/plain 4/32/b/plain 4/40/f/plain "
        "4/40/b/plain 4/48/f/plain 4/48/b/plain 4/56/f/plain 4/56/b/plain 4/64/f/plain "
        "4/64/b/plain 4/72/f/plain 4/72/b/plain 4/80/f/plain 4/80/b/plain 4/88/f/plain "
        "4/88/b/plain 4/96/f/plain 4/96/b/plain 4/104/f/plain 4/104/b/plain "
        "4/112/f/plain 4/112/b/plain 4/120/f/plain 4/120/b/plain 4/128/f/plain "
        "4/128/b/plain 16/8/f/plain 16/8/b/plain 16/16/f/plain 16/16/b/plain "
        "16/24/f/plain 16/24/b/plain 16/32/f/plain 16/32/b/plain 16/40/f/plain "
        "16/40/b/plain 16/48/f/plain 16/48/b/plain 16/56/f/plain 16/56/b/plain "
        "16/64/f/plain 16/64/b/plain 16/72/f/plain 16/72/b/plain 16/80/f/plain "
        "16/80/b/plain 16/88/f/plain 16/88/b/plain 16/96/f/plain 16/96/b/plain "
        "16/104/f/plain 16/104/b/plain 16/112/f/plain 16/112/b/plain 16/120/f/plain "
        "16/120/b/plain 16/128/f/plain 16/128/b/plain "
    ),
    "wwwwwwwwwwwwbbbbbbbbbpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/8/b/auto 4/8/b/auto 16/8/b/auto "
    ),
    "wwwwwwwwwwwwwwwwppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/16/f/auto 4/16/f/auto 16/16/f/auto "
    ),
    "wwwwwwwwwwbbbbbbppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/16/b/auto 4/16/b/auto 16/16/b/auto "
    ),
    "wwwwwwwwwwwwwbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/24/f/auto 4/24/f/auto 16/24/f/auto "
    ),
    "wwwwwwwwwbbbbbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/24/b/auto 4/24/b/auto 16/24/b/auto "
    ),
    "wwwwwwwwwwwppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/32/f/auto 4/32/f/auto 16/32/f/auto "
    ),
    "wwwwwwwwbbbppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/32/b/auto 4/32/b/auto 16/32/b/auto "
    ),
    "wwwwwwwwwbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/40/f/auto 4/40/f/auto 16/40/f/auto "
    ),
    "wwwwwwwbbbpppbppppbpfpbpfpbpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/40/b/auto 4/40/b/auto 16/40/b/auto "
    ),
    "wwwwwwwwpbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/48/f/auto 2/56/f/auto 4/48/f/auto 4/56/f/auto 16/48/f/auto 16/56/f/auto "
    ),
    "wwwwwwwbpbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/48/b/auto 4/48/b/auto 16/48/b/auto "
    ),
    "wwwwwwbbpbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/56/b/auto 4/56/b/auto 16/56/b/auto "
    ),
    "wwwwwwwppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/64/f/auto 4/64/f/auto 16/64/f/auto "
    ),
    "wwwwwwbppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/64/b/auto 4/64/b/auto 16/64/b/auto "
    ),
    "wwwwwwpppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/72/f/auto 2/80/f/auto 4/72/f/auto 4/80/f/auto 16/72/f/auto 16/80/f/auto "
    ),
    "wwwwbbpppbpppbppppbpfpbpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/72/b/auto 2/80/b/auto 4/72/b/auto 4/80/b/auto 16/72/b/auto 16/80/b/auto "
    ),
    "wwwwwwpppbpppbppppbpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/88/f/auto 4/88/f/auto 16/88/f/auto "
    ),
    "wwwwbbpppbpppbppppbpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/88/b/auto 4/88/b/auto 16/88/b/auto "
    ),
    "wwwwpppppbpppbppppbpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/96/f/auto 2/96/b/auto 2/104/f/auto 2/112/f/auto 2/120/f/auto 4/96/f/auto "
        "4/96/b/auto 4/104/f/auto 4/112/f/auto 4/120/f/auto 16/96/f/auto 16/96/b/auto "
        "16/104/f/auto 16/112/f/auto 16/120/f/auto "
    ),
    "wwwbpppppbpppbppppbpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/104/b/auto 2/112/b/auto 2/120/b/auto 4/104/b/auto 4/112/b/auto 4/120/b/auto "
        "16/104/b/auto 16/112/b/auto 16/120/b/auto "
    ),
    "wwwppppppbpppbppppbpfpfpfpfpfpfpfpfpppppppppppppppppppppppppppppppp": (
        "2/128/f/auto 2/128/b/auto 4/128/f/auto 4/128/b/auto 16/128/f/auto 16/128/b/auto "
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
