"""The trace reduction and every per-layer metric's reader on a hand-built
event list (the Chrome trace's shape: host ops, ranges and runtime calls on
a thread, device events joined to their calls by correlation id)."""

from __future__ import annotations

import math

import pytest

from conftest import REPO
from portbench import counts, harness, trace

PEAK, BW = 989e12, 3.35e12


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _dev(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def events(fwd_ranges=1, adam_ranges=1):
    ev = [
        _x("cpu_op", "aten::linear", 0, 100), _x("cpu_op", "aten::addmm", 10, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _dev("nvjet_tst_128x256 (weird gemm)", 200, 100, 1),
        _x("cpu_op", "aten::add", 160, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 165, 2, correlation=3),
        _dev("void at::native::elementwise_kernel<128, 2>(int)", 400, 20, 3),
        _x("user_annotation", "portbench::feed", 180, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 185, 2, correlation=4),
        _dev("void at::native::distribution_elementwise_kernel", 420, 10, 4),
        _x("cpu_op", "aten::nonzero", 340, 30),
        _x("cuda_runtime", "cudaMemcpyAsync", 345, 2, correlation=5),
        _dev("Memcpy DtoH", 440, 5, 5, cat="gpu_memcpy"),
        # the program's kernels, launched inside their ranges (on another
        # thread, as the autograd engine's backward does)
        _x("user_annotation", "maskdit::packed_attention_fwd", 100, 50, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, tid=2, correlation=2),
        _dev("attention_kernel<bf16>", 300, 50, 2),
        _x("user_annotation", "maskdit::fused_adam_ema", 500, 50, tid=2),
        _x("cuda_runtime", "cuLaunchKernel", 510, 5, tid=2, correlation=6),
        _dev("fused_adam_ema_kernel", 600, 40, 6),
    ]
    for i in range(1, fwd_ranges):  # more ranges, without kernels of their own
        ev.append(_x("user_annotation", "maskdit::packed_attention_fwd", 700 + i, 1, tid=2))
    for i in range(1, adam_ranges):
        ev.append(_x("user_annotation", "maskdit::fused_adam_ema", 800 + i, 1, tid=2))
    return ev


def test_reduce_categorises_and_names_gaps():
    tr = trace.reduce(events(), window_s=1e-3)
    cats = {name: cat for cat, name, _, _ in tr.ops}
    assert cats["nvjet_tst_128x256 (weird gemm)"] == "gemm"
    assert cats["attention_kernel<bf16>"] == "kernel:packed_attention_fwd"
    assert cats["void at::native::elementwise_kernel<128, 2>(int)"] == "glue"
    assert cats["void at::native::distribution_elementwise_kernel"] == "feed"
    assert cats["Memcpy DtoH"] == "glue"
    assert cats["fused_adam_ema_kernel"] == "kernel:fused_adam_ema"
    assert tr.ranges == {"packed_attention_fwd": 1, "fused_adam_ema": 1}
    assert tr.busy_s == pytest.approx((100 + 50 + 20 + 10 + 5 + 40) / 1e6)
    assert tr.seconds("gemm") == pytest.approx(100e-6)
    gaps = dict(tr.breakdown()["idle_gaps"])
    # 350 -> 400: the host was in aten::nonzero when the gap began
    assert gaps["aten::nonzero"] == pytest.approx(50e-6)
    ops = dict(tr.breakdown()["device_ops"])
    assert ops["gemm nvjet_tst_128x256"] == pytest.approx(100e-6)
    assert ops["kernel:packed_attention_fwd"] == pytest.approx(50e-6)


def test_gemm_is_known_by_its_host_op():
    ev = [_x("cpu_op", "aten::mm", 0, 10), _x("cuda_runtime", "cudaLaunchKernel", 1, 1,
                                                correlation=9),
          _dev("sm90_kernel_without_a_telling_name", 20, 5, 9)]
    assert trace.reduce(ev, 1.0).ops[0][0] == "gemm"


def _view(tr, units=1, layers=1, evals=1, window=None, device=None):
    layout = {"evals_per_unit": evals, "images_per_unit": 4, "flops_per_image": 1e12,
              "elem_bytes": 2,
              "attention": [(128, 128, 16, 72, layers)], "adam_elements": 1_000_000,
              "adam_bytes_per_element": 36}
    return harness.View(tr, device, layout, units, window or {}, PEAK, BW)


def _reader(name):
    return harness.load_module(REPO / "portbench" / "metrics" / f"{name}.py", "m_" + name)


def test_every_reader_on_the_hand_built_trace():
    tr = trace.reduce(events(), window_s=1e-3)
    device = trace.reduce([e for e in events() if e["pid"] == 0], window_s=2e-3)
    view = _view(tr, window={"train_images_per_s": 100.0, "sample_images_per_s": 10.0},
                 device=device)
    fwd = counts.bound_s(*counts.attention_fwd(128, 128, 16, 72, 2), PEAK, BW)
    adam = counts.bound_s(*counts.adam_ema(1_000_000, 36), PEAK, BW)
    want = {
        "mfu.train": 100 * 100.0 * 1e12 / PEAK,
        "mfu.sample": 100 * 10.0 * 1e12 / PEAK,
        "idle_share.train": 100 * (1 - 225e-6 / 2e-3),
        "idle_share.sample": 100 * (1 - 225e-6 / 2e-3),
        "gemm_ms_per_step.train": 0.1,
        "gemm_ms_per_eval.sample": 0.1,
        "glue_ms_per_step.train": 0.025,
        "glue_ms_per_eval.sample": 0.025,
        "packed_attention_fwd_roofline.train": 100 * fwd / 50e-6,
        "packed_attention_fwd_roofline.sample": 100 * fwd / 50e-6,
        "fused_adam_ema_roofline.train": 100 * adam / 40e-6,
        "packed_attention_bwd_roofline.train": None,  # not in this trace
        "packed_attention_big_fwd_roofline.train": None,
        "packed_attention_big_bwd_roofline.train": None,
    }
    for name, value in want.items():
        got = _reader(name).read(view)
        assert (got is None) if value is None else got == pytest.approx(value), name


def test_per_eval_metrics_divide_by_the_evaluations():
    tr = trace.reduce(events(fwd_ranges=79 * 2), window_s=1e-3)
    view = _view(tr, evals=79, layers=2)
    assert _reader("gemm_ms_per_eval.sample").read(view) == pytest.approx(0.1 / 79)
    assert _reader("gemm_ms_per_step.train").read(view) == pytest.approx(0.1)
    fwd = counts.bound_s(*counts.attention_fwd(128, 128, 16, 72, 2), PEAK, BW)
    got = _reader("packed_attention_fwd_roofline.sample").read(view)
    assert got == pytest.approx(100 * 158 * fwd / 50e-6)


@pytest.mark.parametrize("name,extra", [("packed_attention_fwd_roofline.train", dict(layers=2)),
                                        ("fused_adam_ema_roofline.train", dict(units=2))])
def test_a_launch_count_off_the_shapes_fails_the_reading(name, extra):
    tr = trace.reduce(events(), window_s=1e-3)
    with pytest.raises(harness.MetricError):
        _reader(name).read(_view(tr, **extra))


def test_readers_of_an_empty_trace_read_nothing():
    tr = trace.reduce([], window_s=1.0)
    view = _view(tr, device=tr)
    for name in ("idle_share.train", "gemm_ms_per_step.train", "glue_ms_per_eval.sample",
                 "packed_attention_fwd_roofline.train", "fused_adam_ema_roofline.train",
                 "mfu.train"):
        assert _reader(name).read(view) is None, name
    assert math.isclose(tr.busy_s, 0.0)
