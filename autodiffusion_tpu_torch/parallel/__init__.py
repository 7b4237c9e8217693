"""Process groups, the ('data', 'model') mesh and data parallelism on
torch.distributed (the port's dist_util)."""

from .dist import all_gather_host, barrier, rank, setup_dist, world_size
from .mesh import (data_sharder, data_sharding, global_replicate, make_mesh,
                   param_shardings, replicate, shard_batch)

__all__ = ["data_sharder", "data_sharding", "global_replicate", "make_mesh",
           "param_shardings", "replicate", "shard_batch", "all_gather_host",
           "barrier", "rank", "setup_dist", "world_size"]
