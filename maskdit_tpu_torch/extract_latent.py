"""Latent extraction CLI of the port (counterpart of the repo's
extract_latent.py): an ImageNet-style image folder -> SD-VAE moments -> the
latent LMDB that ``data.category: lmdb`` trains on.

  python -m maskdit_tpu_torch.extract_latent --data_dir ../datasets \
      --ckpt assets/vae/autoencoder_kl.pth --resolution 256 --xflip \
      --outdir ../data/imagenet256-latent [--device cuda]

Reads ``{data_dir}/{split}/<class>/<image>`` through the raw-image LMDB
cache (``imagenet_lmdb_dataset``: ADM's center crop, classes in sorted
order), scales each crop to [-1, 1] and encodes batches with the SD-VAE of
``--ckpt`` (``AutoencoderKL.encode_moments``, fp32 with TF32 off) on
``--device``. Writes ``{outdir}/{data_name}_{resolution}_latent_lmdb/{split}``
with keys ``z-{i}`` (float32 moments), ``y-{i}`` (class text) and
``length``. ``--xflip`` appends the horizontally flipped images' moments
with continuing indices, records [N, 2N) (reference extract_latent.py:81-103),
which the dataset's ``xflip`` view reads.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from maskdit_tpu_torch.data.datasets import imagenet_lmdb_dataset
from maskdit_tpu_torch.data.lmdb_lite import Writer
from maskdit_tpu_torch.models.vae import AutoencoderKL
from maskdit_tpu_torch.utils.port import load_vae


def iter_batches(dataset, batch_size: int) -> Iterator[tuple[np.ndarray, list[int]]]:
    """(images in [-1, 1], NCHW float32; class indices) in record order."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        x = np.stack([img for img, _ in items]).astype(np.float32) / 127.5 - 1.0
        yield x, [int(np.argmax(onehot)) for _, onehot in items]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("latent extraction")
    parser.add_argument("--data_name", default="imagenet", type=str)
    parser.add_argument("--data_dir", default="../datasets", type=str)
    parser.add_argument("--ckpt", default="assets/vae/autoencoder_kl.pth", type=str)
    parser.add_argument("--resolution", default=512, type=int)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--split", default="train", type=str)
    parser.add_argument("--xflip", action="store_true")
    parser.add_argument("--outdir", type=str, default="../data/imagenet512-latent")
    parser.add_argument("--device", type=str, default="cuda", help="torch device to encode on")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {'outdir', 'count': records written, 'seconds':
    the whole run's, 'encode_seconds': the encoder's (synchronised),
    'reader': the image cache's reader kind}."""
    args = build_parser().parse_args(argv)
    if args.split not in ("train", "val"):
        raise ValueError(f"--split {args.split!r}: train or val")
    device = torch.device(args.device)
    t_start = time.perf_counter()
    vae = load_vae(args.ckpt, AutoencoderKL()).to(device)

    outdir = os.path.join(
        args.outdir, f"{args.data_name}_{args.resolution}_latent_lmdb", args.split
    )
    os.makedirs(outdir, exist_ok=True)
    writer = Writer(outdir)
    dataset = imagenet_lmdb_dataset(os.path.join(args.data_dir, args.split),
                                    resolution=args.resolution)
    idx, encode_seconds = 0, 0.0
    begin = time.time()
    for flip in ([False, True] if args.xflip else [False]):
        for x, labels in iter_batches(dataset, args.batch_size):
            if flip:
                x = np.ascontiguousarray(x[:, :, :, ::-1])
            t0 = time.perf_counter()
            moments = vae.encode_moments(torch.from_numpy(x).to(device)).cpu().numpy()
            encode_seconds += time.perf_counter() - t0
            if moments.shape[-1] != args.resolution // 8:
                raise AssertionError(f"moments {moments.shape} at {args.resolution} px")
            for moment, label in zip(moments, labels):
                writer.put(f"z-{idx}", moment.astype(np.float32).tobytes())
                writer.put(f"y-{idx}", str(label))
                idx += 1
            if idx % 5120 < args.batch_size:
                print(f"saved {idx} latents, {time.time() - begin:.1f}s elapsed", flush=True)
                begin = time.time()
    writer.put("length", str(idx))
    writer.commit()
    dataset.close()
    print(f"[finished] saved {idx} latents to {outdir}", flush=True)
    return {"outdir": outdir, "count": idx, "seconds": time.perf_counter() - t_start,
            "encode_seconds": encode_seconds, "reader": dataset.reader_kind}


if __name__ == "__main__":
    main()
