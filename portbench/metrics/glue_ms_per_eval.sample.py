"""glue_ms_per_eval.sample: device ms of PyTorch's elementwise, reduction and
copy kernels per evaluation of the network in the sampler."""

from portbench import readers


def read(view):
    return readers.ms_per_unit(view, "glue", per_eval=True)
