"""ADM evaluation-suite CLI of the port (counterpart of the repo's
evaluator.py, the reference evaluator.py:626-695).

  python -m maskdit_tpu_torch.evaluator ref_batch.npz sample_batch.npz \
      --detector_path assets/pt_inception-2015-12-05.pth

Prints Inception Score, FID, sFID, Precision and Recall, the five lines of
the reference's TF1 tool (evaluator.py:103-108), from the port's
InceptionV3 features on ``--device`` (default cuda).

Inputs:
  * ``sample_batch``: an npz with NHWC uint8 images under ``arr_0``, or a
    directory of PNGs;
  * ``ref_batch``: the same, or an npz of precomputed ``mu`` / ``sigma``
    (and optional ``mu_s`` / ``sigma_s``) statistics; precision and recall
    need the reference's images and are reported n/a without them.
Images stream from the zip or the directory; only the (N x d) feature
matrices are held.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from maskdit_tpu_torch.evals import evaluator as ev
from maskdit_tpu_torch.fid import add_detector_args, build_detector


def batches_for(path: str, batch_size: int):
    if os.path.isdir(path):
        return ev.stream_folder_batches(path, batch_size)
    return ev.stream_npz_batches(path, batch_size)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns the metrics it printed (n/a ones left out)."""
    parser = argparse.ArgumentParser("ADM evaluation suite")
    parser.add_argument("ref_batch", help="reference npz (images and/or mu/sigma) or PNG dir")
    parser.add_argument("sample_batch", help="sample npz or PNG dir")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--save_ref_stats", type=str, default=None,
                        help="write the reference batch's mu/sigma/mu_s/sigma_s to this npz "
                        "(ADM read_statistics format) so future runs skip the reference pass")
    add_detector_args(parser)
    args = parser.parse_args(argv)

    evaluator = ev.Evaluator(build_detector(args), batch=args.batch_size, device=args.device)
    print("computing sample batch activations...")
    sample = evaluator.features_from_batches(batches_for(args.sample_batch, args.batch_size))

    ref_is_npz = not os.path.isdir(args.ref_batch)
    ref_has_images = (not ref_is_npz) or ev.npz_has_key(args.ref_batch, "arr_0")
    ref_has_stats = ref_is_npz and ev.npz_has_key(args.ref_batch, "mu")
    ref = None
    if ref_has_images:
        print("computing reference batch activations...")
        ref = evaluator.features_from_batches(batches_for(args.ref_batch, args.batch_size))

    print("computing/reading reference batch statistics...")
    if ref_has_stats:
        with np.load(args.ref_batch) as obj:
            ref_stats = (obj["mu"], obj["sigma"])
            ref_stats_spatial = (obj["mu_s"], obj["sigma_s"]) if "mu_s" in obj else None
    else:
        if ref is None:
            raise SystemExit(f"reference batch {args.ref_batch!r} has neither images (arr_0) "
                             "nor precomputed statistics (mu/sigma)")
        ref_stats = ev.feature_stats(ref["pool"])
        ref_stats_spatial = ev.feature_stats(ref["spatial"])
        if args.save_ref_stats:
            np.savez(args.save_ref_stats, mu=ref_stats[0], sigma=ref_stats[1],
                     mu_s=ref_stats_spatial[0], sigma_s=ref_stats_spatial[1])
            print(f"saved reference statistics to {args.save_ref_stats}")

    print("Computing evaluations...")
    metrics = {"inception_score": ev.inception_score(sample["logits"]),
               "fid": ev.frechet_distance_from_stats(ev.feature_stats(sample["pool"]), ref_stats)}
    print("Inception Score:", metrics["inception_score"])
    print("FID:", metrics["fid"])
    if ref_stats_spatial is not None:
        metrics["sfid"] = ev.frechet_distance_from_stats(
            ev.feature_stats(sample["spatial"]), ref_stats_spatial)
        print("sFID:", metrics["sfid"])
    else:
        print("sFID: n/a (reference npz lacks mu_s/sigma_s)")
    if ref is not None:
        metrics["precision"], metrics["recall"] = ev.precision_recall(
            ref["pool"], sample["pool"], device=args.device)
        print("Precision:", metrics["precision"])
        print("Recall:", metrics["recall"])
    else:
        print("Precision: n/a (reference batch has no raw images)")
        print("Recall: n/a (reference batch has no raw images)")
    return metrics


if __name__ == "__main__":
    main()
