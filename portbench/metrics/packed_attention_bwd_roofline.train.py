"""packed_attention_bwd_roofline.train: kernel packed_attention_bwd's share of its roofline (%)."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, "packed_attention_bwd", backward=True)
