"""Objective factory (objective_function.cpp:9-20), the counterpart of
lightgbm_tpu/objectives/__init__.py: gradients and hessians as f32
tensors on the training device."""
from __future__ import annotations

from ..utils import log
from .binary import BinaryLogloss
from .multiclass import MulticlassLogloss
from .rank import LambdarankNDCG
from .regression import RegressionL2Loss

OBJECTIVE_CLASSES = {"regression": RegressionL2Loss, "binary": BinaryLogloss,
                     "lambdarank": LambdarankNDCG,
                     "multiclass": MulticlassLogloss}


def create_objective(objective_type: str, config):
    cls = OBJECTIVE_CLASSES.get(objective_type)
    if cls is None:
        log.fatal("Unknown objective type name: %s" % objective_type)
    return cls(config)
