"""Plain float64 gradients, one module an objective, found by the
objective's name in a configuration's ``params`` (``binary.py``,
``lambdarank.py``).  Each module defines

- ``make(table, params, device)``: a function of the training scores
  ``[K, N]`` (float64) to the gradient and hessian ``[K, N]``;
- ``pairs(table)``: the gradient's work beyond its pass over the rows,
  in pairs of rows (``cost.objective_s``), 0 where there is none.

An objective the cells do not train yet is a new module here.
"""
from __future__ import annotations

import importlib


def load(name: str):
    """The module of objective ``name``."""
    return importlib.import_module(__name__ + "." + name)
