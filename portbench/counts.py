"""The yardstick's arithmetic: the chip's peaks, the model's FLOPs and each
kernel's operations and bytes.

The FLOP model is the port's ``utils/profiling.py`` (itself the JAX
package's), copied so that the benchmark holds it: 2*M*N*K per product of
the transformer blocks only, backward = 2x forward, the CFG sampler's
2 * steps - 1 evaluations on a doubled batch.

A kernel's bound counts the work the operation needs, whatever implements
it: attention forward = 2 products of 2*N*H*L^2*hd FLOPs, reading q, k, v
and writing o (4 planes of N*L*H*hd elements); attention backward = 5
products (the probabilities once, then dV, dP, dQ, dK), reading q, k, v and
dO and writing dq, dk and dv (7 planes); the fused Adam + EMA update = 17
operations per element and the bytes its dtypes move (g, p, m, v and the
EMA read, p, m, v and the EMA written). The bound is the larger of
operations over the peak rate and bytes over the memory bandwidth.
"""

from __future__ import annotations

# dense bf16 tensor rate (FLOP/s) and HBM bandwidth (B/s) by a substring of
# torch.cuda.get_device_name(): NVIDIA's data sheet for the SXM part at 700 W
PEAKS = (
    ("H100 80GB HBM3", 989e12, 3.35e12),
    ("H100 SXM", 989e12, 3.35e12),
)

ADAM_OPS_PER_ELEMENT = 17


def peaks(device_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the named card; raises for a card not listed."""
    for key, flops, bandwidth in PEAKS:
        if key in device_name:
            return flops, bandwidth
    raise ValueError(f"no peaks known for {device_name!r} (known: {[k for k, *_ in PEAKS]})")


def block_flops(l: int, d: int, mlp_ratio: float) -> float:
    """One transformer block's forward FLOPs per sample (matmuls only)."""
    qkv = 2 * l * d * 3 * d
    attn = 2 * 2 * l * l * d
    proj = 2 * l * d * d
    mlp = 2 * 2 * l * d * int(d * mlp_ratio)
    ada = 2 * d * 6 * d
    return float(qkv + attn + proj + mlp + ada)


def forward_flops(cfg: dict, encoder_tokens: int) -> float:
    """Per-sample forward FLOPs of the encoder at ``encoder_tokens`` and the
    decoder at every token."""
    tokens = (cfg["in_size"] // cfg["patch_size"]) ** 2
    dd = cfg["decoder_hidden_size"]
    return (cfg["depth"] * block_flops(encoder_tokens, cfg["hidden_size"], cfg["mlp_ratio"])
            + cfg["decoder_depth"] * block_flops(tokens, dd, cfg["mlp_ratio"]))


def train_flops_per_image(cfg: dict, mask_ratio: float) -> float:
    tokens = (cfg["in_size"] // cfg["patch_size"]) ** 2
    return 3.0 * forward_flops(cfg, int(tokens * (1 - mask_ratio)))


def sample_flops_per_image(cfg: dict, num_steps: int, cfg_scale: float) -> float:
    tokens = (cfg["in_size"] // cfg["patch_size"]) ** 2
    evals = 2 * num_steps - 1
    return forward_flops(cfg, tokens) * evals * (2.0 if cfg_scale != 1.0 else 1.0)


def attention_fwd(n: int, l: int, h: int, hd: int, elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of attention's forward at (N, L, H, hd)."""
    plane = n * l * h * hd
    return 2 * 2.0 * n * h * l * l * hd, 4.0 * plane * elem_bytes


def attention_bwd(n: int, l: int, h: int, hd: int, elem_bytes: int) -> tuple[float, float]:
    """(FLOPs, bytes) of attention's backward at (N, L, H, hd)."""
    plane = n * l * h * hd
    return 5 * 2.0 * n * h * l * l * hd, 7.0 * plane * elem_bytes


def adam_bytes_per_element(g: int = 4, m: int = 4, v: int = 4) -> int:
    """Bytes per element of the fused update: g read; p, m, v, EMA read and
    written (p and the EMA fp32)."""
    return g + 2 * (4 + m + v + 4)


def adam_ema(elements: int, bytes_per_element: int) -> tuple[float, float]:
    """(operations, bytes) of the fused Adam + EMA update."""
    return float(ADAM_OPS_PER_ELEMENT * elements), float(bytes_per_element * elements)


def bound_s(flops: float, nbytes: float, peak_flops: float, bandwidth: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(flops / peak_flops, nbytes / bandwidth)
