"""Process groups and host-level collectives on torch.distributed.

Port of autodiffusion_tpu/parallel/dist.py, which replaced
guided_diffusion/dist_util.py:21-98 with jax.distributed; here the
reference's own stack comes back: one process per GPU, started by
``torchrun`` (or given its coordinator explicitly), NCCL between GPUs and
gloo between CPU processes. Without either, everything is a
single-process no-op, as in the JAX package.

The collectives stage through the group's device: a CUDA tensor on the
process's GPU under NCCL (which moves nothing else), a CPU tensor under
gloo. ``all_gather_host`` does so too, so it needs no side group.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["setup_dist", "rank", "world_size", "barrier", "all_gather_host"]

_INITIALIZED = False
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def setup_dist(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> None:
    """Join the process group.

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` it initialises from ``tcp://host:port``; without them,
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``); with neither it does nothing (one
    process). ``device`` is the entry point's: ``cuda`` takes NCCL, after
    ``torch.cuda.set_device(LOCAL_RANK)``, and raises where CUDA or NCCL is
    missing (no fallback to gloo); ``cpu`` takes gloo. A second call with
    coordinator arguments after a group is up raises, as the JAX
    package's does: the group can only be made once."""
    global _INITIALIZED
    if _INITIALIZED:
        if coordinator_address is not None:
            raise RuntimeError(
                "setup_dist called with coordinator args after an earlier "
                "setup_dist already initialised the process group; it can "
                "only be initialised once")
        return
    if dist.is_initialized():            # a caller's own group
        _INITIALIZED = True
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("setup_dist with a coordinator address needs "
                             "num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
        local = int(os.environ.get("LOCAL_RANK", process_id))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init = dict(init_method="env://")
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        return
    if resolve_device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; a CUDA process "
                               "group needs it (gloo is for --device cpu)")
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no GPU: {torch.cuda.device_count()}"
                " visible (one process per GPU)")
        torch.cuda.set_device(local)
        # device_id makes NCCL connect now, so a failed init raises here
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                **init)
    else:
        dist.init_process_group("gloo", **init)
    _INITIALIZED = True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def comm_device() -> torch.device:
    """The device the group's collectives run on: this process's GPU under
    NCCL, the CPU otherwise."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "barrier") -> None:
    """Cross-process sync (dist.barrier, image_sample.py:366)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_host(x: Any) -> Any:
    """Host (numpy) data of every process: ``x`` itself in one process,
    else a numpy array [world, *x.shape] in x's dtype, rank-ordered
    (process_allgather's untiled result; dist.all_gather of samples,
    search_...py:356-361). Every process passes the same shape."""
    if world_size() == 1:
        return x
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a).to(comm_device())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """``op`` in place on ``tensors``, one call a dtype and device: a
    lone contiguous tensor on the group's device (a flat gradient buffer)
    as it is, any others through a flat buffer staged on the group's
    device and copied back into each."""
    dev = comm_device()
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for (_, home), ts in groups.items():
            if len(ts) == 1 and home == dev and ts[0].is_contiguous():
                op(ts[0])
                continue
            flat = torch.cat([t.detach().reshape(-1) for t in ts]).to(dev)
            op(flat)
            parts = flat.to(home).split([t.numel() for t in ts])
            torch._foreach_copy_(ts, [p.view_as(t) for p, t in zip(parts, ts)])


def all_reduce_(tensors: List[torch.Tensor], group=None,
                mean: bool = False) -> None:
    """Sum (or average) ``tensors`` in place over ``group``'s ranks, one
    all-reduce a dtype. Runs whenever a group is up, one rank
    included."""
    if not dist.is_initialized() or not tensors:
        return

    n = dist.get_world_size(group)

    def op(flat):
        dist.all_reduce(flat, group=group)
        if mean and n > 1:
            flat /= n

    _flat_collective(tensors, op)


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in place (dist_util.py
    sync_params)."""
    if not dist.is_initialized() or not tensors:
        return
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))
