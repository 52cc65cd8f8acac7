"""MaskDiT with EDM preconditioning in plain PyTorch, written from the equations.

MaskDiT (Zheng et al., "Fast Training of Diffusion Models with Masked
Transformers", arXiv 2306.09305) is a DiT (Peebles & Xie, arXiv 2212.09748):
patch embedding, timestep and label embeddings, pre-LN transformer blocks
conditioned by adaLN-Zero, then a light decoder of narrower blocks and a
final adaLN linear layer. In training the encoder runs on the kept patches
only; the decoder runs on all patches, a learned mask token in the dropped
places. EDM's preconditioning (Karras et al., arXiv 2206.00364, Table 1)
wraps the network.

The parameters are a dict of tensors under the port's state-dict names
(``param_spec``), so one set of seeded tensors loads into both. Every
product goes through an ``ops`` object: ``Fp32Ops`` is the reference (run
it under ``exact_fp32()`` on a card, so that no product uses TF32), and
``reference/fp8.py``'s ``Fp8Ops`` is the control. Nothing here imports the
program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FREQ_DIM = 256  # the timestep embedder's sinusoidal width (DiT)


class Fp32Ops:
    """Every product in fp32."""

    def linear(self, x, w, b=None):
        return F.linear(x, w, b)

    def matmul(self, a, b):
        return a @ b

    def conv(self, x, w, b, stride):
        return F.conv2d(x, w, b, stride=stride)

    def act(self, x):
        """An activation the network holds between products (the residual
        stream, the conditioning)."""
        return x


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32 (matmuls and cuDNN), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _block_spec(prefix: str, d: int, c_dim: int, mlp_ratio: float) -> list:
    m = int(d * mlp_ratio)
    return [
        (prefix + "attn.qkv.weight", (3 * d, d)), (prefix + "attn.qkv.bias", (3 * d,)),
        (prefix + "attn.proj.weight", (d, d)), (prefix + "attn.proj.bias", (d,)),
        (prefix + "mlp.fc1.weight", (m, d)), (prefix + "mlp.fc1.bias", (m,)),
        (prefix + "mlp.fc2.weight", (d, m)), (prefix + "mlp.fc2.bias", (d,)),
        (prefix + "adaLN_modulation.1.weight", (6 * d, c_dim)),
        (prefix + "adaLN_modulation.1.bias", (6 * d,)),
    ]


def param_spec(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in a fixed order: the port's
    state-dict names (the network under ``model.``)."""
    d, c, p = cfg["hidden_size"], cfg["in_channels"], cfg["patch_size"]
    dd = cfg["decoder_hidden_size"]
    spec = [
        ("x_embedder.proj.weight", (d, c, p, p)), ("x_embedder.proj.bias", (d,)),
        ("t_embedder.mlp.0.weight", (d, FREQ_DIM)), ("t_embedder.mlp.0.bias", (d,)),
        ("t_embedder.mlp.2.weight", (d, d)), ("t_embedder.mlp.2.bias", (d,)),
        ("y_embedder.embedding_table.weight", (d, cfg["num_classes"])),
    ]
    for i in range(cfg["depth"]):
        spec += _block_spec(f"blocks.{i}.", d, d, cfg["mlp_ratio"])
    spec += [
        ("decoder_layer.adaLN_modulation.1.weight", (2 * d, d)),
        ("decoder_layer.adaLN_modulation.1.bias", (2 * d,)),
        ("decoder_layer.linear.weight", (dd, d)), ("decoder_layer.linear.bias", (dd,)),
    ]
    for i in range(cfg["decoder_depth"]):
        spec += _block_spec(f"decoder_blocks.{i}.", dd, d, cfg["mlp_ratio"])
    if cfg["mae_loss_coef"] > 0:
        spec.append(("mask_token", (1, 1, dd)))
    spec += [
        ("final_layer.adaLN_modulation.1.weight", (2 * dd, d)),
        ("final_layer.adaLN_modulation.1.bias", (2 * dd,)),
        ("final_layer.linear.weight", (p * p * c, dd)), ("final_layer.linear.bias", (p * p * c,)),
    ]
    return [("model." + name, shape) for name, shape in spec]


def make_params(spec, seed: int, device, std: float = 0.02) -> dict[str, torch.Tensor]:
    """Every tensor of ``spec`` drawn N(0, std^2) in fp32 from ``seed``: one
    draw over all of them on ``device``, cut in ``spec``'s order. Returns
    views of that one buffer, by name."""
    total = sum(math.prod(shape) for _, shape in spec)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    flat.mul_(std)
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def sincos_2d(dim: int, grid: int, device) -> torch.Tensor:
    """MAE's fixed 2-D sin-cos table (grid*grid, dim), rows in row-major
    patch order: the first half of the features encodes the column, the
    second the row, each as [sin | cos] of pos * 10000^(-k / (dim/4))."""
    def one_d(pos):
        k = torch.arange(dim // 4, dtype=torch.float64, device=device) / (dim / 4.0)
        ang = pos.reshape(-1, 1) * (1.0 / 10000 ** k)[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)

    rows, cols = torch.meshgrid(torch.arange(grid, dtype=torch.float64, device=device),
                                torch.arange(grid, dtype=torch.float64, device=device),
                                indexing="ij")
    return torch.cat([one_d(cols), one_d(rows)], dim=1).float()


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _block(P, pre, x, c_act, heads, ops):
    w = lambda k: P[pre + k]
    mod = ops.linear(c_act, w("adaLN_modulation.1.weight"), w("adaLN_modulation.1.bias"))
    shift1, scale1, gate1, shift2, scale2, gate2 = mod.chunk(6, dim=-1)
    n, l, d = x.shape
    hd = d // heads
    qkv = ops.linear(_modulate(layer_norm(x), shift1, scale1), w("attn.qkv.weight"),
                     w("attn.qkv.bias"))
    q, k, v = qkv.view(n, l, 3, heads, hd).permute(2, 0, 3, 1, 4)
    probs = torch.softmax(ops.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    attn = ops.matmul(probs, v).transpose(1, 2).reshape(n, l, d)
    x = ops.act(x + gate1[:, None] * ops.linear(attn, w("attn.proj.weight"),
                                                  w("attn.proj.bias")))
    h = ops.linear(_modulate(layer_norm(x), shift2, scale2), w("mlp.fc1.weight"),
                   w("mlp.fc1.bias"))
    h = F.gelu(h, approximate="tanh")
    return ops.act(x + gate2[:, None] * ops.linear(h, w("mlp.fc2.weight"), w("mlp.fc2.bias")))


def _adaln_linear(P, pre, x, c_act, ops):
    shift, scale = ops.linear(c_act, P[pre + "adaLN_modulation.1.weight"],
                              P[pre + "adaLN_modulation.1.bias"]).chunk(2, dim=-1)
    return ops.linear(_modulate(layer_norm(x), shift, scale), P[pre + "linear.weight"],
                      P[pre + "linear.bias"])


def network(P, cfg, x, t, y, ids_keep=None, ops=None):
    """F(x, t, y): (N, C, H, W) -> (N, C, H, W). ``ids_keep`` (N, K), where
    given, lists each sample's kept patches (row-major patch index): the
    encoder sees only those, and the decoder gets the mask token in the
    other places."""
    ops = ops or Fp32Ops()
    P = {k[len("model."):]: v for k, v in P.items()}
    p, d, dd = cfg["patch_size"], cfg["hidden_size"], cfg["decoder_hidden_size"]
    n, c, hh, ww = x.shape
    grid = hh // p
    tok = ops.conv(x, P["x_embedder.proj.weight"], P["x_embedder.proj.bias"], p)
    tok = ops.act(tok.flatten(2).transpose(1, 2) + sincos_2d(d, grid, x.device)[None])
    if ids_keep is not None:
        tok = torch.gather(tok, 1, ids_keep[..., None].expand(-1, -1, d))

    half = FREQ_DIM // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=x.device) / half)
    ang = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    c_emb = ops.linear(F.silu(ops.linear(emb, P["t_embedder.mlp.0.weight"],
                                         P["t_embedder.mlp.0.bias"])),
                       P["t_embedder.mlp.2.weight"], P["t_embedder.mlp.2.bias"])
    c_emb = ops.act(c_emb + ops.linear(y, P["y_embedder.embedding_table.weight"]))
    c_act = F.silu(c_emb)

    for i in range(cfg["depth"]):
        tok = _block(P, f"blocks.{i}.", tok, c_act, cfg["num_heads"], ops)
    tok = _adaln_linear(P, "decoder_layer.", tok, c_act, ops)
    if ids_keep is not None:
        token = P.get("mask_token", torch.zeros((1, 1, dd), device=x.device))
        full = token.reshape(1, 1, dd).expand(n, grid * grid, dd)
        keep = torch.zeros((n, grid * grid, 1), device=x.device, dtype=torch.bool)
        keep.scatter_(1, ids_keep[..., None], True)
        placed = torch.zeros((n, grid * grid, dd), device=x.device, dtype=tok.dtype)
        placed = placed.scatter(1, ids_keep[..., None].expand(-1, -1, dd), tok)
        tok = torch.where(keep, placed, full)
    tok = ops.act(tok + sincos_2d(dd, grid, x.device)[None])
    for i in range(cfg["decoder_depth"]):
        tok = _block(P, f"decoder_blocks.{i}.", tok, c_act, cfg["decoder_num_heads"], ops)
    out = _adaln_linear(P, "final_layer.", tok, c_act, ops)  # (N, L, p*p*C), (p, q, c)
    out = out.reshape(n, grid, grid, p, p, c).permute(0, 5, 1, 3, 2, 4)
    return out.reshape(n, c, hh, ww)


def denoise(P, cfg, x, sigma, y, ids_keep=None, ops=None, cfg_scale=None):
    """EDM's D(x; sigma) = c_skip x + c_out F(c_in x, ln(sigma) / 4, y).
    With ``cfg_scale`` the network runs on the doubled batch (y, then the
    zero label) and its output is F_u + s (F_c - F_u)."""
    sd = cfg["sigma_data"]
    s = sigma.float().reshape(-1, 1, 1, 1)
    c_skip = sd ** 2 / (s ** 2 + sd ** 2)
    c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
    c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
    c_noise = torch.log(s).reshape(-1) / 4
    if cfg_scale is None:
        f = network(P, cfg, c_in * x, c_noise, y, ids_keep, ops)
    else:
        both = network(P, cfg, torch.cat([c_in * x] * 2), torch.cat([c_noise] * 2),
                       torch.cat([y, torch.zeros_like(y)]), None, ops)
        cond, uncond = both.chunk(2)
        f = uncond + cfg_scale * (cond - uncond)
    return c_skip * x + c_out * f
