"""idle_share.sample: the device's idle share (%) in the device-only capture."""

from portbench import readers


def read(view):
    return readers.idle_share(view)
