"""Objective factory (objective_function.cpp:9-20); this slice ports the
binary objective only."""
from __future__ import annotations

from ..utils import log
from .binary import BinaryLogloss


def create_objective(objective_type: str, config):
    if objective_type == "binary":
        return BinaryLogloss(config)
    log.fatal("Objective %s is not supported by lightgbm_tpu_torch "
              "(outside the ported slice)" % objective_type)
