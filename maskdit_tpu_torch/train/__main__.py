"""``python -m maskdit_tpu_torch.train``: the training CLI (train/cli.py)."""

from maskdit_tpu_torch.train.cli import main

main()
