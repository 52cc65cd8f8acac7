from maskdit_tpu_torch.ops.attention import mha_reference

__all__ = ["mha_reference"]
