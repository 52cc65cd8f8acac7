from maskdit_tpu_torch.data import lmdb_lite
from maskdit_tpu_torch.data.datasets import (
    Dataset,
    ImageFolderDataset,
    ImageNetLatentDataset,
    SyntheticLatentDataset,
    center_crop_arr,
    write_latent_lmdb,
)
from maskdit_tpu_torch.data.loader import DataLoader, prefetch, to_device

__all__ = [
    "lmdb_lite", "Dataset", "ImageFolderDataset", "ImageNetLatentDataset",
    "SyntheticLatentDataset", "center_crop_arr", "write_latent_lmdb",
    "DataLoader", "prefetch", "to_device",
]
