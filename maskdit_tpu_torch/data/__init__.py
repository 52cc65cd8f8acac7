from maskdit_tpu_torch.data.datasets import ImageFolderDataset, SyntheticLatentDataset
from maskdit_tpu_torch.data.loader import DataLoader, prefetch, to_device

__all__ = ["ImageFolderDataset", "SyntheticLatentDataset", "DataLoader", "prefetch", "to_device"]
