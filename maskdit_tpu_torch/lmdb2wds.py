"""LMDB -> WebDataset shard conversion of the port (counterpart of the repo's
lmdb2wds.py, the same flags, shard names and keys).

  python -m maskdit_tpu_torch.lmdb2wds --datadir ../data/imagenet512-latent/imagenet_512_latent_lmdb \
      --outdir ../data/imagenet512-wds [--maxcount 10010] [--resolution 64]

Reads a latent LMDB (``ImageNetLatentDataset``'s layout, native reader) and
writes tar shards ``latent_imagenet_{resolution * 8}_{split}-%04d.tar`` with
members ``{index:07d}.latent`` (a pickled numpy array) and
``{index:07d}.cls``, which ``data.category: webdataset`` trains on.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from maskdit_tpu_torch.data.datasets import ImageNetLatentDataset
from maskdit_tpu_torch.data.wds import write_wds_shards


def main(argv: Optional[Sequence[str]] = None) -> list[str]:
    """Run the CLI; returns the shards' paths."""
    parser = argparse.ArgumentParser("Convert the latent imagenet dataset to WebDataset")
    parser.add_argument("--maxcount", type=int, default=10010)
    parser.add_argument("--maxsize", type=int, default=10 ** 10)
    parser.add_argument("--outdir", type=str, default="latent_imagenet_wds")
    parser.add_argument("--datadir", type=str, default="latent_imagenet")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--num_channels", type=int, default=8)
    parser.add_argument("--split", type=str, default="train")
    args = parser.parse_args(argv)

    dataset = ImageNetLatentDataset(
        args.datadir, resolution=args.resolution,
        num_channels=args.num_channels, split=args.split,
    )

    def records():
        for i in range(len(dataset)):
            img, label = dataset[i]
            yield f"{i:07d}", img, int(np.argmax(label))

    pattern = f"latent_imagenet_{args.resolution * 8}_{args.split}-%04d.tar"
    paths = write_wds_shards(
        records(), args.outdir, pattern=pattern,
        maxcount=args.maxcount, maxsize=args.maxsize,
    )
    dataset.close()
    print(f"wrote {len(paths)} shards to {args.outdir}")
    return paths


if __name__ == "__main__":
    main()
