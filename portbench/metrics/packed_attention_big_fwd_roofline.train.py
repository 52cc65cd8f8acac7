"""packed_attention_big_fwd_roofline.train: kernel packed_attention_big_fwd's share of
its roofline (%)."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, "packed_attention_big_fwd", backward=False)
