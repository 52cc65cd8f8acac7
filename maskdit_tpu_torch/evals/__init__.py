from maskdit_tpu_torch.evals import fid
from maskdit_tpu_torch.evals.evaluator import (
    Evaluator,
    frechet_distance,
    inception_score,
    precision_recall,
)
from maskdit_tpu_torch.evals.inception import (
    InceptionV3,
    make_detector,
    random_state_dict,
)

__all__ = [
    "fid", "Evaluator", "frechet_distance", "inception_score", "precision_recall",
    "InceptionV3", "make_detector", "random_state_dict",
]
