"""gemm_ms_per_eval.sample: device ms of matrix products per evaluation of the
network in the sampler."""

from portbench import readers


def read(view):
    return readers.ms_per_unit(view, "gemm", per_eval=True)
