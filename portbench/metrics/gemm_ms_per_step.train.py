"""gemm_ms_per_step.train: device ms of matrix products per train step."""

from portbench import readers


def read(view):
    return readers.ms_per_unit(view, "gemm")
