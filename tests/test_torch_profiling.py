"""The port's FLOP model and MFU against the JAX package's.

The FLOP counts are the same formulas; the peak is the card's, chosen from
its device name, and an unknown card raises instead of borrowing a peak.
"""

import pytest

from maskdit_tpu.utils import profiling as jax_profiling
from maskdit_tpu_torch.utils import profiling


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
