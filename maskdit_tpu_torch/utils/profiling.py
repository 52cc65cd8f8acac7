"""Analytic FLOP counts, model FLOPs utilisation, device memory and traces.

Counterpart of maskdit_tpu/utils/profiling.py:

  * ``dit_forward_flops``, ``maskdit_train_flops_per_image``,
    ``maskdit_sample_flops_per_image`` and ``mfu``: the same FLOP model
    (2*M*N*K per matmul, backward = 2x forward). The peak is the card's
    dense bf16 tensor rate, chosen from the device name; a card not listed
    raises rather than borrow another's peak.
  * ``device_memory_stats``: the allocator's bytes in use, peak and limit
    in GiB under the JAX function's names; ``{}`` for a device without
    such statistics (the CPU), as the JAX function returns for one.
  * ``trace``: a context manager around ``torch.profiler.profile`` (the
    JAX one wraps ``jax.profiler``) that writes a Chrome trace, read by
    tools/torch_trace_report.py.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional

import torch

# dense bf16 tensor-core peaks, TFLOP/s, by a substring of
# torch.cuda.get_device_name(): NVIDIA's data sheets (SXM parts, 700 W)
PEAK_BF16_TFLOPS = (
    ("H100 80GB HBM3", 989.0),  # H100 SXM
    ("H100 SXM", 989.0),
    ("H200", 989.0),  # H200 SXM
)


def peak_bf16_tflops(device_name: str) -> float:
    """Dense bf16 peak of the named card; raises for a card not listed."""
    for key, peak in PEAK_BF16_TFLOPS:
        if key in device_name:
            return peak
    raise ValueError(
        f"no bf16 peak known for '{device_name}' (known: "
        f"{[k for k, _ in PEAK_BF16_TFLOPS]})"
    )


def dit_forward_flops(
    depth: int,
    hidden: int,
    seq_len: int,
    mlp_ratio: float = 4.0,
    decoder_depth: int = 0,
    decoder_hidden: int = 512,
    decoder_seq_len: Optional[int] = None,
) -> float:
    """Per-sample forward FLOPs of the transformer blocks (matmuls only)."""

    def block_flops(l: int, d: int) -> float:
        qkv = 2 * l * d * 3 * d
        attn = 2 * 2 * l * l * d
        proj = 2 * l * d * d
        mlp = 2 * 2 * l * d * int(d * mlp_ratio)
        ada = 2 * d * 6 * d  # per sample (c is (D,))
        return qkv + attn + proj + mlp + ada

    total = depth * block_flops(seq_len, hidden)
    if decoder_depth:
        total += decoder_depth * block_flops(decoder_seq_len or seq_len, decoder_hidden)
    return float(total)


def maskdit_train_flops_per_image(
    model_type: str = "DiT-XL/2",
    input_size: int = 32,
    mask_ratio: float = 0.5,
    use_decoder: bool = True,
) -> float:
    """Analytic train-step FLOPs per image (forward + 2x for backward)."""
    from maskdit_tpu_torch.models import dit

    cfg = dit.DIT_CONFIGS[model_type]
    l_full = (input_size // cfg["patch_size"]) ** 2
    l_enc = int(l_full * (1 - mask_ratio))
    fwd = dit_forward_flops(
        cfg["depth"], cfg["hidden_size"], l_enc,
        decoder_depth=dit.DECODER_DEPTH if use_decoder else 0,
        decoder_hidden=dit.DECODER_HIDDEN_SIZE,
        decoder_seq_len=l_full,
    )
    return 3.0 * fwd


def maskdit_sample_flops_per_image(
    model_type: str = "DiT-XL/2",
    input_size: int = 32,
    num_steps: int = 40,
    cfg_scale: float = 1.5,
    use_decoder: bool = True,
) -> float:
    """Analytic FLOPs per sampled image of the Heun EDM sampler: ``2 *
    num_steps - 1`` evaluations (an Euler and a correction evaluation per
    step, none on the last; reference sample.py:30-66), each an unmasked
    forward with the decoder, the batch doubled by classifier-free guidance
    where ``cfg_scale`` is not 1 (reference maskdit.py:570-587)."""
    from maskdit_tpu_torch.models import dit

    cfg = dit.DIT_CONFIGS[model_type]
    l_full = (input_size // cfg["patch_size"]) ** 2
    fwd = dit_forward_flops(
        cfg["depth"], cfg["hidden_size"], l_full,
        decoder_depth=dit.DECODER_DEPTH if use_decoder else 0,
        decoder_hidden=dit.DECODER_HIDDEN_SIZE,
        decoder_seq_len=l_full,
    )
    evals = 2 * num_steps - 1
    return float(fwd * evals * (2.0 if cfg_scale != 1.0 else 1.0))


def mfu(images_per_sec: float, flops_per_image: float, peak_tflops: float) -> float:
    """Model FLOPs utilisation in [0, 1]."""
    return images_per_sec * flops_per_image / (peak_tflops * 1e12)


def device_memory_stats(device: Optional[Any] = None) -> dict[str, float]:
    """The caching allocator's bytes in use, peak and limit of a CUDA device
    (default the current one) in GiB, as ``mem_in_use_gib``,
    ``mem_peak_gib`` and ``mem_limit_gib`` (reference: the peak-memory
    prints, train.py:248-249); ``{}`` for a CPU device."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    gib = 1024 ** 3
    out = {}
    for key, name in (
        ("allocated_bytes.all.current", "mem_in_use_gib"),
        ("allocated_bytes.all.peak", "mem_peak_gib"),
    ):
        if key in stats:
            out[name] = stats[key] / gib
    out["mem_limit_gib"] = torch.cuda.get_device_properties(device).total_memory / gib
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with torch.profiler (host ops, and the card's
    kernels where there is one) and write a Chrome trace,
    ``<log_dir>/trace_<time>.json``; tools/torch_trace_report.py reads it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))
