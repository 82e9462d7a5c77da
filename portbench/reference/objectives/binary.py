"""Plain float64 binary log-loss gradients (LightGBM
binary_objective.hpp, labels to -1/+1): ``r = -2·l·σ / (1 + exp(2·l·σ·s))``,
gradient ``r``, hessian ``|r|·(2σ - |r|)``.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def binary(score: torch.Tensor, label: torch.Tensor, sigmoid: float = 1.0):
    s = score.to(F64)
    sign = torch.where(label > 0, 1.0, -1.0).to(F64)
    r = -2.0 * sign * sigmoid / (1.0 + torch.exp(2.0 * sign * sigmoid * s))
    return r, r.abs() * (2.0 * sigmoid - r.abs())


def make(table, params: dict, device):
    """score [1, N] -> (gradient, hessian) [1, N], float64."""
    label = torch.as_tensor(table.y, device=device)
    sigmoid = float(params.get("sigmoid", 1.0))

    def gradients(score):
        g, h = binary(score[0], label, sigmoid)
        return g[None], h[None]
    return gradients


def pairs(table) -> int:
    return 0
