"""Analytic FLOP counts and model FLOPs utilisation on the card.

Counterpart of maskdit_tpu/utils/profiling.py (dit_forward_flops,
maskdit_train_flops_per_image, mfu): the FLOP model is the same (2*M*N*K
per matmul, backward = 2x forward). The peak is the card's dense bf16
tensor rate, chosen from the device name; a card not listed raises rather
than borrow another's peak.
"""

from __future__ import annotations

from typing import Optional

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


def mfu(images_per_sec: float, flops_per_image: float, peak_tflops: float) -> float:
    """Model FLOPs utilisation in [0, 1]."""
    return images_per_sec * flops_per_image / (peak_tflops * 1e12)
