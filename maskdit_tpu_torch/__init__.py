"""maskdit_tpu_torch: the PyTorch and CUDA port of maskdit_tpu.

It mirrors the JAX package's layout (models/, ops/, sampling/, train/,
data/, evals/, utils/) so each module's counterpart is found by path, and it is
held against that
package in the tests. Plain tensor code is PyTorch; each Pallas kernel of
the JAX package becomes a hand-written Hopper kernel under ops/csrc/,
built at first use. Nothing is built or loaded when the package is
imported, and nothing here imports jax.

Ported so far: the EDM sampling path (EDMPrecond over MaskDiT, the EDM and
ablation samplers, the generate CLI with the SD-VAE decode to PNGs), the
masked training path (masking, the EDM + MAE loss, the train step, the
trainer with its eval hook and the train CLI), the latent data path (the
latent LMDB with a native reader, WebDataset shards, the extract_latent and
lmdb2wds CLIs), the evaluation path (InceptionV3, FID / IS / sFID / precision-recall, the fid,
evaluator and eval_latent CLIs), and all seven kernels of the JAX package
(ops/csrc/).
"""

__version__ = "0.1.0"
