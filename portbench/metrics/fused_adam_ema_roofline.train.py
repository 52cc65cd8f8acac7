"""fused_adam_ema_roofline.train: the fused Adam + EMA update's share of its
roofline (%)."""

from portbench import readers


def read(view):
    return readers.adam_roofline(view)
