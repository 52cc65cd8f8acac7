"""Data-parallel training over the process group.

The port's counterpart of the data axis of maskdit_tpu/parallel/sharded.py
and mesh.py (``batch_spec``: the batch split over processes;
``replicated``: every parameter, moment and EMA whole on every process),
as the reference trains with DDP over NCCL (SURVEY L0: init_processes,
dist.all_reduce). Each process holds the whole train state; rank 0's is
broadcast once at the start, and each step

  * takes the step's draws for the whole global batch and keeps its own
    rows (``train/state.py``), so the step equals one process's step on
    the global batch;
  * accumulates its local gradient as one process would;
  * all-reduces that flat gradient ONCE, as its mean, in fp32 (also under
    a bf16 accumulator, as the JAX package's GSPMD reduction runs in fp32,
    maskdit_tpu/train/state.py:445-454), and stores it back in the
    accumulator's dtype;
  * runs the fused update on every process, which keeps the replicas
    equal bit for bit;
  * averages its metrics.

Given the mesh (``parallel/mesh.py``), the data axis is the mesh's: a
process's rows are those of its (data, fsdp) coordinate, the gradient is
all-reduced over the data group (the fsdp sum is the sharded state's
reduce-scatter, ``parallel/sharded.py``) and divided by data x fsdp, and the
metrics are averaged over data x fsdp. A mesh of ``data = world`` runs the
collectives of the default group, as without a mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from maskdit_tpu_torch.parallel.dist import process_count, process_index
from maskdit_tpu_torch.parallel.mesh import Mesh, group_size


class DataParallel:
    """The collectives of data-parallel training on the default group, or
    on the data axis of ``mesh``. ``rank`` / ``world``: this process's
    block of the global batch and the number of blocks."""

    def __init__(self, mesh: Optional[Mesh] = None):
        if not dist.is_initialized():
            raise RuntimeError("DataParallel needs the process group (parallel.dist."
                               "init_distributed)")
        if mesh is None:
            self.rank, self.world = process_index(), process_count()
            self._grad_group = self._metric_group = None
            self._reduce_grad = self._reduce_metrics = True
        else:
            self.rank, self.world = mesh.batch_index, mesh.batch_count
            self._grad_group, self._metric_group = mesh.groups["data"], mesh.groups["batch"]
            self._reduce_grad = group_size(mesh, "data") > 1
            self._reduce_metrics = group_size(mesh, "batch") > 1
        # the stop flag travels on the CPU (gloo), so agreeing on it does
        # not wait for the card
        self._host_group = (dist.new_group(backend="gloo")
                            if dist.get_backend() == "nccl" else None)

    def broadcast_(self, *tensors: torch.Tensor) -> None:
        """Overwrite each tensor with rank 0's, in place."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def mean_gradient_(self, grads: torch.Tensor) -> None:
        """Replace ``grads`` with the mean of every process's flat gradient,
        reduced in fp32 and stored back in ``grads``' dtype (a bf16
        accumulator gets the fp32 mean rounded once), so the update reads
        the gradient dtype a process alone gives it, as the JAX package's
        gradient tree keeps the accumulator's dtype after the fp32
        reduction."""
        g = grads if grads.dtype == torch.float32 else grads.float()
        if self._reduce_grad:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=self._grad_group)
        g.div_(self.world)
        if g is not grads:
            grads.copy_(g)

    def mean_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each 0-d metric averaged over the processes (one all-reduce)."""
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].detach().float() for k in keys])
        if self._reduce_metrics:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self._metric_group)
        flat.div_(self.world)
        return {k: flat[i] for i, k in enumerate(keys)}

    def any(self, flag: bool) -> bool:
        """True on every process if it is True on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._host_group)
        return bool(t.item())


def data_parallel(mesh: Optional[Mesh] = None) -> Optional[DataParallel]:
    """A ``DataParallel`` (on ``mesh``'s data axis, where given) when there
    is a process group (of one process too: its collectives are then the
    identity, which a run of one rank shows), else None (one process trains
    alone)."""
    return DataParallel(mesh) if dist.is_initialized() else None
