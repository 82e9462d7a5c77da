"""Distributed tree learning over ``torch.distributed``.

Counterpart of lightgbm_tpu/parallel/: the reference's two parallel
learners, ``tree_learner=data`` (rows sharded, histograms summed over
the world by ``psum`` or ``reduce_scatter``) and ``tree_learner=feature``
(features owned, the best split reduced over the world), each rank one
process (learners.py), and the world they run in: the bootstrap from
torch's environment, the backend rule and the collectives (mesh.py).
Both learners drive the one grower of models/grower_unified.py through
its ``SeamSchedule``.  ``hybrid`` and ``voting`` are ROADMAP A9b.
"""
from __future__ import annotations

from .learners import create_parallel_learner, distributed_bin_finder
from .mesh import (get_num_machines, get_rank, init_distributed, shutdown,
                   sync_up_by_min)

__all__ = ["create_parallel_learner", "distributed_bin_finder",
           "get_num_machines", "get_rank", "init_distributed", "shutdown",
           "sync_up_by_min"]
