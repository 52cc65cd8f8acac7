"""FID CLI of the port (counterpart of the repo's fid.py): calc and ref.

  python -m maskdit_tpu_torch.fid calc --images gen_dir --ref ref_stats.npz \
      --detector_path assets/pt_inception-2015-12-05.pth
  python -m maskdit_tpu_torch.fid ref --data dataset_dir --dest ref_stats.npz ...

The detector is the port's InceptionV3 with the community
``pt_inception-2015-12-05`` weights (the network the reference's StyleGAN3
pickle wraps). ``--random_detector`` runs the whole pipeline on random
weights (a machinery run: the values are meaningless). On ``--device``
(default cuda; ``cuda:LOCAL_RANK`` for each of several processes). Under
``python -m torch.distributed.run`` each process streams its rank-strided
images, the statistics are summed over the processes, and rank 0 prints
and writes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from maskdit_tpu_torch.evals import fid as fid_lib
from maskdit_tpu_torch.evals.inception import Detector, make_detector, random_state_dict
from maskdit_tpu_torch.parallel import dist
from maskdit_tpu_torch.utils.port import load_inception


def build_detector(args: argparse.Namespace, device=None) -> Detector:
    """The detector that ``--random_detector`` / ``--detector_path`` ask
    for, on ``device`` (default ``--device``)."""
    device = args.device if device is None else device
    if args.random_detector:
        dist.mprint("WARNING: random detector weights; FID values are meaningless")
        return make_detector(random_state_dict(0), device)
    if not args.detector_path or not os.path.exists(args.detector_path):
        raise SystemExit("need --detector_path pointing at the pt_inception-2015-12-05 "
                         "state dict (see download_assets.py / pytorch-fid), or "
                         "--random_detector for a machinery-only run")
    return make_detector(load_inception(args.detector_path), device)


def add_detector_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--detector_path", type=str, default=None)
    parser.add_argument("--random_detector", action="store_true",
                        help="random InceptionV3 weights (machinery runs only)")


def main(argv: Optional[Sequence[str]] = None) -> Optional[float]:
    """Run the CLI; returns the FID in calc mode."""
    parser = argparse.ArgumentParser("FID calculation")
    parser.add_argument("mode", choices=["calc", "ref"])
    parser.add_argument("--images", type=str, help="generated image folder")
    parser.add_argument("--ref", type=str, help="reference stats .npz (calc)")
    parser.add_argument("--data", type=str, help="dataset folder (ref mode)")
    parser.add_argument("--dest", type=str, help="output stats path (ref mode)")
    parser.add_argument("--num", type=int, default=50000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda")
    add_detector_args(parser)
    args = parser.parse_args(argv)

    if args.mode == "calc" and not (args.images and args.ref):
        parser.error("calc needs --images and --ref")
    if args.mode == "ref" and not (args.data and args.dest):
        parser.error("ref needs --data and --dest")
    created = dist.init_distributed(device=args.device)
    try:
        detector = build_detector(args, dist.local_device(args.device))
        if args.mode == "ref":
            fid_lib.ref(args.data, args.dest, args.batch, detector)
            return None
        value = fid_lib.calc(args.images, args.ref, args.num, args.seed, args.batch, detector)
        dist.mprint(f"FID: {value:.4f}")
        dist.mprint(value)
        return value
    finally:
        if created:
            dist.shutdown()


if __name__ == "__main__":
    main()
