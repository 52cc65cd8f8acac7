"""mfu.train: the train step's share of the bf16 peak (%), from the window's images/s."""

from portbench import readers


def read(view):
    return readers.mfu(view, "train_images_per_s")
