from maskdit_tpu_torch.ops.attention import mha_reference
# importing the package registers the forward kernels #1, #3 and #5 as the
# torch ops maskdit_torch::packed_attention_fwd, ::packed_attention_big_fwd
# and ::flash_fwd: all a process needs to run an exported sampler
from maskdit_tpu_torch.ops import flash, flash_batched, flash_big  # noqa: F401

__all__ = ["mha_reference"]
