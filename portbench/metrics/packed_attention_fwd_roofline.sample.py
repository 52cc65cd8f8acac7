"""packed_attention_fwd_roofline.sample: kernel packed_attention_fwd's share of its roofline (%)."""

from portbench import readers


def read(view):
    return readers.attention_roofline(view, "packed_attention_fwd", backward=False)
