"""Multi-process runtime of the port: the process group (``dist``),
data-parallel training over it (``data_parallel``) and the JAX mesh's
FSDP and tensor axes (``mesh``, ``sharded``)."""
