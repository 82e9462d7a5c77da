"""L2 regression objective, in torch.

Counterpart of lightgbm_tpu/objectives/regression.py
(regression_objective.hpp:10-53): grad = score − label, hess = 1, both
times the row weight, in f32 on tensors of the training device.  Each
step is one exactly rounded f32 operation, so the card, the CPU and the
JAX package compute the same gradients.
"""
from __future__ import annotations

import torch


class RegressionL2Loss:
    def __init__(self, config):
        self.weights = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        if metadata.weights is not None:
            self.weights = torch.as_tensor(metadata.weights,
                                           dtype=torch.float32, device=device)

    def get_gradients(self, score: torch.Tensor):
        grad = score.to(torch.float32) - self.label
        hess = torch.ones_like(grad)
        if self.weights is not None:
            grad = grad * self.weights
            hess = hess * self.weights
        return grad, hess

    @property
    def sigmoid(self) -> float:
        return -1.0
