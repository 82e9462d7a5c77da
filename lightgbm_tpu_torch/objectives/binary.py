"""Binary logloss objective, in torch.

Counterpart of lightgbm_tpu/objectives/binary.py (binary_objective.hpp:
13-102): the same labels-to-{-1, +1} mapping, ``is_unbalance`` weighting
and f32 gradient formula as ``_binary_gradients`` (:80-94), on tensors of
the training device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import log


class BinaryLogloss:
    def __init__(self, config):
        self.is_unbalance = config.is_unbalance
        self._sigmoid = float(config.sigmoid)
        if self._sigmoid <= 0.0:
            log.fatal("Sigmoid parameter %f :should greater than zero"
                      % self._sigmoid)
        self.weights = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        label = np.asarray(metadata.label)
        cnt_positive = int((label == 1).sum())
        cnt_negative = num_data - cnt_positive
        log.info("Number of positive:%d,  number of negative:%d"
                 % (cnt_positive, cnt_negative))
        if cnt_positive == 0 or cnt_negative == 0:
            log.fatal("Input training data only contains one class")
        neg_weight = (cnt_positive / cnt_negative if self.is_unbalance
                      else 1.0)
        f32 = torch.float32
        self.label_sign = torch.as_tensor(
            np.where(label == 1, 1.0, -1.0), dtype=f32, device=device)
        self.label_weight = torch.as_tensor(
            np.where(label == 1, 1.0, neg_weight), dtype=f32, device=device)
        self.sig = torch.tensor(self._sigmoid, dtype=f32, device=device)
        if metadata.weights is not None:
            self.weights = torch.as_tensor(metadata.weights, dtype=f32,
                                           device=device)

    def get_gradients(self, score: torch.Tensor):
        """response = -2·l·σ/(1+exp(2·l·σ·s)); hess = |r|(2σ-|r|).

        Each step is one f32 operation, as in the JAX package, except
        ``exp``: it runs in float64 and rounds once to f32, because the
        CPU's and the card's f32 ``exp`` may differ in the last bit and the
        int8 mode's quantization would carry that difference into the
        trees.  Rounded from f64, both devices get the same gradients."""
        sig, ls = self.sig, self.label_sign
        e = torch.exp((2.0 * ls * sig * score).to(torch.float64))
        response = -2.0 * ls * sig / (1.0 + e.to(torch.float32))
        abs_response = response.abs()
        grad = response * self.label_weight
        hess = abs_response * (2.0 * sig - abs_response) * self.label_weight
        if self.weights is not None:
            grad = grad * self.weights
            hess = hess * self.weights
        return grad, hess

    @property
    def sigmoid(self) -> float:
        return self._sigmoid
