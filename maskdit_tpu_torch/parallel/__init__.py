"""Multi-process runtime of the port: the process group (``dist``) and
data-parallel training over it (``data_parallel``)."""
