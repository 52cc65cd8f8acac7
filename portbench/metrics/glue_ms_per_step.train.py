"""glue_ms_per_step.train: device ms of PyTorch's elementwise, reduction and
copy kernels per train step."""

from portbench import readers


def read(view):
    return readers.ms_per_unit(view, "glue")
