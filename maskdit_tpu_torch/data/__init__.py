from maskdit_tpu_torch.data.datasets import SyntheticLatentDataset
from maskdit_tpu_torch.data.loader import DataLoader, prefetch, to_device

__all__ = ["SyntheticLatentDataset", "DataLoader", "prefetch", "to_device"]
