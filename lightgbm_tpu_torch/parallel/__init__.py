"""Distributed tree learning over ``torch.distributed``.

Counterpart of lightgbm_tpu/parallel/: the reference's two parallel
learners, ``tree_learner=data`` (rows sharded, histograms summed over
the world by ``psum`` or ``reduce_scatter``) and ``tree_learner=feature``
(features owned, the best split reduced over the world), and the JAX
package's two on a 2-D grid of ranks, ``hybrid`` (rows over the data
index, feature blocks over the feature index) and ``voting`` (PV-tree
top-k voting over the data shards), each rank one process
(learners.py), and the world they run in: the bootstrap from torch's
environment, the backend rule, the collectives and the grid's groups
(mesh.py).  Every learner drives the one grower of
models/grower_unified.py through its ``SeamSchedule``.
"""
from __future__ import annotations

from .learners import create_parallel_learner, distributed_bin_finder
from .mesh import (get_num_machines, get_rank, init_distributed, shutdown,
                   sync_up_by_min)

__all__ = ["create_parallel_learner", "distributed_bin_finder",
           "get_num_machines", "get_rank", "init_distributed", "shutdown",
           "sync_up_by_min"]
