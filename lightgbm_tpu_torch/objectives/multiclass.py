"""Multiclass softmax objective, in torch.

Counterpart of lightgbm_tpu/objectives/multiclass.py
(multiclass_objective.hpp:13-92): the score is [K, N]; softmax over the
classes of each row, grad = p − 1[y = k], hess = 2p(1 − p), times the row
weight.  The softmax subtracts each row's maximum in f32 as
``jax.nn.softmax`` does, then takes ``exp`` and its sum over K in float64
and rounds p once to f32: the CPU's and the card's f32 ``exp`` may differ
in the last bit, and the int8 mode's quantization would carry that into
the trees (objectives/binary.py does the same for its ``exp``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log


class MulticlassLogloss:
    def __init__(self, config):
        self.num_class = int(config.num_class)
        self.weights = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        label = np.asarray(metadata.label).astype(np.int32)
        if ((label < 0) | (label >= self.num_class)).any():
            log.fatal("Label must be in [0, %d)" % self.num_class)
        self.onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[label].T.copy(),
            device=device)                                     # [K, N]
        if metadata.weights is not None:
            self.weights = torch.as_tensor(metadata.weights,
                                           dtype=torch.float32, device=device)

    def get_gradients(self, score: torch.Tensor):
        """``score`` [K, N] -> (grad, hess), each [K, N] f32."""
        z = score.to(torch.float32)
        z = z - z.max(dim=0, keepdim=True).values
        e = torch.exp(z.to(torch.float64))
        p = (e / e.sum(dim=0, keepdim=True)).to(torch.float32)
        grad = p - self.onehot
        hess = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            grad = grad * self.weights[None, :]
            hess = hess * self.weights[None, :]
        return grad, hess

    @property
    def sigmoid(self) -> float:
        return -1.0
