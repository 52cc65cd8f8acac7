"""counts.py at the kernel table's shapes: the forward and #7 bounds match
the bound column of PERF.md's kernel table (ms, to its four decimals),
and the FLOP model and the parameter count match the port's."""

from __future__ import annotations

import json

import pytest

from conftest import REPO
from portbench import counts
from portbench.reference import maskdit

PEAK, BW = counts.peaks("NVIDIA H100 80GB HBM3")

# (N, L, H, hd) in bf16 -> the table's bound (ms) of #1 / #3 / #5
FORWARD_ROWS = [
    ((16, 256, 16, 72), 0.0113), ((16, 256, 16, 32), 0.0050), ((128, 128, 16, 72), 0.0451),
    ((128, 256, 16, 32), 0.0401), ((8, 1024, 16, 72), 0.0391), ((8, 1024, 16, 32), 0.0174),
    ((32, 512, 16, 72), 0.0451), ((32, 1024, 16, 32), 0.0695), ((64, 256, 16, 72), 0.0451),
    ((128, 129, 16, 72), 0.0454),
]


@pytest.mark.parametrize("shape,bound_ms", FORWARD_ROWS)
def test_forward_bound_matches_the_kernel_table(shape, bound_ms):
    got = counts.bound_s(*counts.attention_fwd(*shape, 2), PEAK, BW) * 1e3
    assert round(got, 4) == bound_ms


@pytest.mark.parametrize("bytes_per_element,bound_ms", [(36, 7.8460), (32, 6.9742), (34, 7.4101),
                                                        (26, 5.6666), (18, 3.9230), (28, 6.1025)])
def test_adam_bound_matches_the_kernel_table(bytes_per_element, bound_ms):
    got = counts.bound_s(*counts.adam_ema(730_115_216, bytes_per_element), PEAK, BW) * 1e3
    assert round(got, 4) == bound_ms


def test_adam_bytes_of_the_fp32_update():
    assert counts.adam_bytes_per_element() == 36
    assert counts.adam_bytes_per_element(g=2, m=2, v=2) == 26


def test_backward_counts_five_products_and_seven_planes():
    flops, nbytes = counts.attention_bwd(2, 64, 4, 8, 2)
    f_fwd, b_fwd = counts.attention_fwd(2, 64, 4, 8, 2)
    assert flops == pytest.approx(2.5 * f_fwd) and nbytes == pytest.approx(1.75 * b_fwd)


def _config(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_flops_per_image_of_the_cells():
    cfg256 = _config("maskdit-xl2-256")
    assert counts.train_flops_per_image(cfg256, 0.5) / 1e9 == pytest.approx(392.1, abs=0.05)
    assert counts.sample_flops_per_image(cfg256, 40, 1.5) / 1e12 == pytest.approx(39.69, abs=0.01)
    # train512 runs train256's tokens: 32 x 512 = 128 x 128 in the encoder
    cfg512 = _config("maskdit-xl2-512")
    assert counts.train_flops_per_image(cfg512, 0.5) > 4 * counts.train_flops_per_image(
        cfg256, 0.5)


def test_flops_match_the_ports_model():
    from maskdit_tpu_torch.utils import profiling

    cfg = _config("maskdit-xl2-256")
    assert counts.train_flops_per_image(cfg, 0.5) == profiling.maskdit_train_flops_per_image()
    assert counts.sample_flops_per_image(cfg, 40, 1.5) == \
        profiling.maskdit_sample_flops_per_image()


@pytest.mark.parametrize("name", ["maskdit-xl2-256", "maskdit-xl2-512"])
def test_parameter_count_is_dit_xl2_with_the_decoder(name):
    spec = maskdit.param_spec(_config(name))
    assert sum(int(__import__("math").prod(s)) for _, s in spec) == 730_115_216


def test_an_unknown_card_has_no_peak():
    with pytest.raises(ValueError):
        counts.peaks("NVIDIA A100-SXM4-80GB")
