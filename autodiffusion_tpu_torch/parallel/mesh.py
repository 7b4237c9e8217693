"""The ('data', 'model') mesh of the processes and the data-parallel rules.

Port of autodiffusion_tpu/parallel/mesh.py. There, parallelism is data
layout: a device mesh, shardings on arrays, and XLA inserts the
collectives. Here each process holds its own tensors, so the same rules
are explicit: a data-parallel process takes its contiguous slice of every
global batch (``shard_batch`` / ``data_sharder``), its gradients and
statistics are all-reduced over the 'data' axis (``DataSharder``'s
reductions), and "replicated" parameters are a broadcast from rank 0
(dist_util.py:83-89 sync_params). Every process already holds a whole
copy of every argument, so the JAX package's ``place_fn`` (which made
host arrays global) has no counterpart.

Tensor parallelism stays a plan: ``param_shardings`` gives each parameter
its DTensor placements by the JAX rule; no command runs a tensor-parallel
step, in either package (every ``make_mesh()`` of the JAX CLI is
``model_parallel=1``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .dist import all_reduce_, broadcast_, comm_device, world_size

__all__ = ["Mesh", "DataSharder", "make_mesh", "data_sharding", "replicate",
           "shard_batch", "param_shardings", "data_sharder",
           "global_replicate"]

AXES = ("data", "model")


class Mesh:
    """A ('data', 'model') grid of ranks: ``shape`` {"data": d, "model":
    m}, this rank's coordinate on each axis, and the axis's process group
    (a ``DeviceMesh`` when a process group is up; one rank without)."""

    def __init__(self, shape: Tuple[int, int], device_mesh=None):
        self.shape = dict(zip(AXES, shape))
        self.device_mesh = device_mesh

    def coordinate(self, axis: str) -> int:
        return (0 if self.device_mesh is None
                else self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        return (None if self.device_mesh is None
                else self.device_mesh.get_group(axis))


def make_mesh(model_parallel: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """('data', 'model') mesh over all (or the given) ranks, row-major: the
    ranks of one data index are consecutive. Without a process group it is
    the one-rank mesh."""
    ranks = list(devices) if devices is not None else \
        list(range(world_size()))
    n = len(ranks)
    assert n % model_parallel == 0, (n, model_parallel)
    shape = (n // model_parallel, model_parallel)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group "
                             "(setup_dist)")
        return Mesh(shape)
    from torch.distributed.device_mesh import DeviceMesh

    return Mesh(shape, DeviceMesh(comm_device().type,
                                  torch.tensor(ranks).reshape(shape),
                                  mesh_dim_names=AXES))


class DataSharder:
    """This rank's contiguous slice of a global batch along its leading
    axis (rank-0 values pass through), and reductions over the ranks of the
    mesh's 'data' axis. A batch that does not divide by the data axis
    raises, as the JAX package's device_put does. ``ndim``, when given, is
    the rank every sliced array must have. Without a mesh it is one rank's:
    every row, and no reduction, whether or not a process group is up."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 ndim: Optional[int] = None):
        mesh = mesh if mesh is not None else Mesh((1, 1))
        self.size = mesh.shape["data"]
        self.index = mesh.coordinate("data")
        self.group = mesh.group("data")
        self.ndim = ndim

    def __call__(self, x):
        if x is None or np.ndim(x) == 0:
            return x
        if self.ndim is not None and np.ndim(x) != self.ndim:
            raise ValueError(f"expected a rank-{self.ndim} batch, got shape "
                             f"{tuple(x.shape)}")
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"a batch of {n} does not divide over the "
                             f"{self.size} data-parallel ranks")
        b = n // self.size
        return x[self.index * b:(self.index + 1) * b]

    def all_reduce_sum_(self, tensors: List[torch.Tensor]) -> None:
        """Sum ``tensors`` in place over the data axis (one all-reduce a
        dtype, whenever the mesh has a group, one rank included)."""
        if self.group is not None:
            all_reduce_(tensors, self.group)

    def all_reduce_mean_(self, tensors: List[torch.Tensor]) -> None:
        """Average ``tensors`` in place over the data axis."""
        if self.group is not None:
            all_reduce_(tensors, self.group, mean=True)


def data_sharding(mesh: Mesh, ndim: int = 4) -> DataSharder:
    """The batch-axis slicing of a rank-``ndim`` array."""
    return DataSharder(mesh, ndim)


def data_sharder(mesh: Mesh) -> DataSharder:
    """fn(x) -> this rank's rows of x (any rank), with the data axis's
    reductions: the ``shard_fn`` of the fitness pipelines and the
    ``data_sharder`` of the train steps."""
    return DataSharder(mesh)


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every array of a host or device batch (a dict,
    list or tuple of them); rank-0 leaves pass through."""
    return _tree_map(DataSharder(mesh), batch)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate(mesh: Mesh, tree):
    """Every parameter and buffer of a module, or every tensor of a tree,
    overwritten in place by rank 0's (dist_util.py:83-89 sync_params); the
    tree is returned. Each process holds its whole copy already, so there
    is nothing to place. A no-op without a process group."""
    broadcast_(_tensors(tree), src=0)
    return tree


def global_replicate(mesh: Mesh, tree):
    """``replicate``: in the JAX package the form for a mesh that spans
    processes; here every mesh does."""
    return replicate(mesh, tree)


def param_shardings(mesh: Mesh, params, *, min_weight_size: int = 2 ** 16
                    ) -> Dict[str, Tuple[Any, Any]]:
    """Tensor-parallel placements for each parameter of a module (or a
    name -> tensor mapping), one per mesh axis ('data', 'model'): a weight
    of at least two dims and ``min_weight_size`` elements whose output axis
    divides by the 'model' axis is sharded on it over 'model', all else is
    ``Replicate()``. The JAX package's rule, on torch's layout: the output
    axis is dim 0 (Linear [out, in], Conv [out, in, kh, kw]) where flax has
    it last; an Embedding's output axis (its features) is last in both."""
    from torch.distributed.tensor import Replicate, Shard

    msize = mesh.shape["model"]
    last = set()
    if isinstance(params, nn.Module):
        last = {f"{n}.weight" for n, m in params.named_modules()
                if isinstance(m, nn.Embedding)}
        params = dict(params.named_parameters())

    def rule(name, x):
        out = x.dim() - 1 if name in last else 0
        if (msize > 1 and x.dim() >= 2 and x.numel() >= min_weight_size
                and x.shape[out] % msize == 0):
            return (Replicate(), Shard(out))
        return (Replicate(), Replicate())

    return {name: rule(name, x) for name, x in params.items()}
