"""The process group: bootstrap, rank-0 gating and host collectives.

Counterpart of maskdit_tpu/parallel/dist.py (reference: utils.py:84-112
init_processes / mprint / cleanup, train.py:245 all_reduce, train.py:271
barrier) over ``torch.distributed``. Under ``python -m
torch.distributed.run`` the group comes from its environment (env://);
otherwise from the explicit coordinator address, process count and id, as
the JAX CLIs take them. The backend is what the caller asks for, else
NCCL for a CUDA device and gloo for the CPU; nothing falls back to another
backend or to one process. Without a group every function here is the
one-process identity.
"""

from __future__ import annotations

import builtins
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> bool:
    """Join the process group; returns True if this call created it.

    One process (no coordinator, no count above 1 and no launcher
    environment) does nothing. ``coordinator_address`` is ``host:port`` of
    rank 0's rendezvous (the twin of ``jax.distributed.initialize``'s,
    maskdit_tpu/parallel/dist.py:19-47); without it the group comes from
    ``torch.distributed.run``'s environment. ``backend`` defaults to nccl
    when ``device`` is a CUDA device, gloo otherwise.
    """
    if dist.is_initialized():
        return False
    from_env = all(k in os.environ for k in _LAUNCHER_ENV)
    if coordinator_address is None and not from_env:
        if num_processes not in (None, 1):
            raise ValueError(f"--num_processes {num_processes} needs --coordinator host:port "
                             "(or a launch by torch.distributed.run)")
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    return True


def shutdown() -> None:
    """Leave the process group (after a barrier), if there is one."""
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its machine (``LOCAL_RANK`` of the
    launcher, else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_device(device: str) -> torch.device:
    """The device a process trains on: ``cuda`` without an index is
    ``cuda:LOCAL_RANK``; an explicit ``cuda:i`` (several ranks sharing one
    card) or ``cpu`` stays as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def is_main_process() -> bool:
    return process_index() == 0


def mprint(*args: Any, **kwargs: Any) -> None:
    """Print from process 0 only (reference: utils.py:97-102)."""
    if is_main_process():
        builtins.print(*args, **kwargs)


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Wait for every process (reference: dist.barrier at train.py:271)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_sum_array(value: np.ndarray) -> np.ndarray:
    """Sum a host array over the processes (reference: dist.all_reduce at
    fid.py:78-79), in its own dtype."""
    value = np.asarray(value)
    if not dist.is_initialized():
        return value
    t = torch.from_numpy(np.ascontiguousarray(value)).to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def all_reduce_mean_scalar(value: float) -> float:
    """Average a host scalar over the processes (the loss-logging
    all-reduce, reference train.py:245-247)."""
    if not dist.is_initialized():
        return float(value)
    total = all_reduce_sum_array(np.asarray([float(value)], dtype=np.float64))
    return float(total[0]) / process_count()
