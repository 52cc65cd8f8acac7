"""The port's FLOP model, MFU, memory statistics and traces against the JAX package's.

The FLOP counts are the same formulas (the sampler's for every DiT config,
input size, step count, guidance and decoder choice); the peak is the
card's, chosen from its device name, and an unknown card raises instead of
borrowing a peak. ``device_memory_stats`` returns the JAX function's names
(checked through a stubbed ``torch.cuda``) and nothing for the CPU;
``trace`` writes a Chrome trace that tools/torch_trace_report.py reads.
"""

import json
import os
import sys
import types

import pytest
import torch

from maskdit_tpu.models import dit as jax_dit
from maskdit_tpu.utils import profiling as jax_profiling
from maskdit_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("model_type,size,ratio,decoder", [
    ("DiT-XL/2", 32, 0.5, True), ("DiT-XL/2", 64, 0.5, True),
    ("DiT-XL/2", 32, 0.0, False), ("DiT-B/4", 32, 0.75, True),
])
def test_train_flops_match_jax(model_type, size, ratio, decoder):
    ours = profiling.maskdit_train_flops_per_image(model_type, size, ratio, decoder)
    theirs = jax_profiling.maskdit_train_flops_per_image(model_type, size, ratio, decoder)
    assert ours == theirs > 0


def test_forward_flops_and_mfu_match_jax():
    kw = dict(depth=4, hidden=96, seq_len=40, mlp_ratio=4.0, decoder_depth=2,
              decoder_hidden=64, decoder_seq_len=80)
    assert profiling.dit_forward_flops(**kw) == jax_profiling.dit_forward_flops(**kw)
    assert profiling.mfu(150.0, 4e11, 989.0) == pytest.approx(
        jax_profiling.mfu(150.0, 4e11, peak_tflops=989.0))
    # DiT-XL/2 @256 at mask 0.5: 392.1 GFLOP per image
    assert profiling.maskdit_train_flops_per_image() == pytest.approx(392.087e9, rel=1e-5)


def test_peak_is_the_named_cards():
    assert profiling.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0
    with pytest.raises(ValueError, match="no bf16 peak"):
        profiling.peak_bf16_tflops("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("decoder", [True, False], ids=["decoder", "no_decoder"])
@pytest.mark.parametrize("cfg_scale", [1.0, 1.5])
@pytest.mark.parametrize("steps", [1, 40])
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("model_type", sorted(jax_dit.DIT_CONFIGS))
def test_sample_flops_match_jax(model_type, size, steps, cfg_scale, decoder):
    ours = profiling.maskdit_sample_flops_per_image(model_type, size, steps, cfg_scale, decoder)
    theirs = jax_profiling.maskdit_sample_flops_per_image(model_type, size, steps, cfg_scale,
                                                          decoder)
    assert ours == theirs > 0


def test_device_memory_stats_empty_on_cpu():
    assert profiling.device_memory_stats("cpu") == {}
    assert profiling.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_device_memory_stats_names_match_jax(monkeypatch):
    """Through a stubbed ``torch.cuda``: the allocator's bytes in use and
    peak, and the card's memory, under the JAX function's names, in GiB."""
    gib = 1024 ** 3
    stats = {"allocated_bytes.all.current": 3 * gib, "allocated_bytes.all.peak": 5 * gib,
             "reserved_bytes.all.current": 6 * gib}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(total_memory=80 * gib))
    ours = profiling.device_memory_stats()
    assert ours == {"mem_in_use_gib": 3.0, "mem_peak_gib": 5.0, "mem_limit_gib": 80.0}

    class Device:
        def memory_stats(self):
            return {"bytes_in_use": 3 * gib, "peak_bytes_in_use": 5 * gib,
                    "bytes_limit": 80 * gib}

    assert jax_profiling.device_memory_stats(Device()) == ours


def test_trace_writes_a_chrome_trace_the_report_reads(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_trace_report

    with profiling.trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.glob("trace_*.json")
    assert torch_trace_report.newest_trace(str(tmp_path)) == str(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert torch_trace_report.main([str(tmp_path), "1"])["events"] == 0  # no card here
    assert "device total: 0.0 ms/step" in capsys.readouterr().out
