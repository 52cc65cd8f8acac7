"""maskdit_tpu_torch: the PyTorch and CUDA port of maskdit_tpu.

It mirrors the JAX package's layout (models/, ops/, sampling/, train/,
data/, utils/) so each module's counterpart is found by path, and it is
held against that
package in the tests. Plain tensor code is PyTorch; each Pallas kernel of
the JAX package becomes a hand-written Hopper kernel under ops/csrc/,
built at first use. Nothing is built or loaded when the package is
imported, and nothing here imports jax.

Ported so far: the EDM sampling path (EDMPrecond over MaskDiT, the EDM and
ablation samplers, the generate CLI without VAE decode), the masked
training path (masking, the EDM + MAE loss, the train step, the trainer
and the train CLI, on synthetic latents), and three kernels: packed
attention forward and backward and the fused Adam + EMA update.
"""

__version__ = "0.1.0"
