"""Seeded weights into the program's model.

Every tensor of the model is drawn N(0, 0.02^2) from the seed by its name
(``reference.maskdit.make_params``: one draw on the card, cut in the
reference's order), with none of the program's zero initialisations, so
that every path of the network carries signal and the same tensors load
into the program and the reference.
"""

from __future__ import annotations

import torch

from portbench.reference import maskdit as ref_model

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def load_weights(model, spec, seed: int, device) -> None:
    """The seeded tensors of ``spec`` into ``model``'s parameters, by name;
    the program's names and shapes must be the reference's."""
    params = dict(model.named_parameters())
    have = {k: tuple(v.shape) for k, v in params.items()}
    want = {k: tuple(s) for k, s in spec}
    if have != want:
        extra, missing = sorted(set(have) - set(want)), sorted(set(want) - set(have))
        shapes = sorted(k for k in set(have) & set(want) if have[k] != want[k])
        raise ValueError(f"the program's parameters differ from the reference's: extra "
                         f"{extra[:5]}, missing {missing[:5]}, shapes {shapes[:5]}")
    values = ref_model.make_params(spec, seed, device)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(values[name])
