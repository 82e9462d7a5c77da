"""Lambdarank (NDCG) objective, in torch.

Counterpart of lightgbm_tpu/objectives/rank.py (rank_objective.hpp:
19-230), the same formulation on tensors of the training device: every
query is padded to the longest query's length ``qmax`` ([nq, qmax] doc
index, padding scored −inf), and each block of queries computes its
whole pairwise [qmax, qmax] lambda matrix at once.  The block keeps the
[block, qmax, qmax] working set near 2^24 entries (64 MB per f32 array);
a block holds a handful of such arrays at a time.

Math (rank_objective.hpp:76-164), per query in descending score order
(a stable sort, so tied scores keep document order and padding sinks
last):

- pairs (high, low) with label(high) > label(low);
- ΔNDCG = (gain_hi − gain_lo)·|disc_hi − disc_lo|·inv_max_dcg, divided
  by 0.01 + |Δs| when the query's best and worst scores differ;
- sig = 2/(1 + exp(2·Δs·σ)); λ = −sig·ΔNDCG added to the high document
  and subtracted from the low one; hessian 2·ΔNDCG·sig(2 − sig) added to
  both; then times the row weight.

Two steps differ from the JAX package's f32 graph so that the card and
the CPU compute the same gradients: ``exp`` runs in float64 and rounds
once to f32 (the devices' f32 ``exp`` may differ in the last bit, as in
objectives/binary.py), and each document's row and column sums of its
f32 pair terms accumulate in float64 and round once.  Every other step
is one exactly rounded f32 operation, so the devices differ only where
two float64 sums in another order round to neighbouring f32 values.
Against the JAX package, whose f32 sums run in XLA's order, the lambdas
agree to f32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..metrics.dcg import DCGCalculator
from ..utils import log


class LambdarankNDCG:
    def __init__(self, config):
        self._sigmoid = float(config.sigmoid)
        if self._sigmoid <= 0.0:
            log.fatal("sigmoid param %f should greater than zero"
                      % self._sigmoid)
        self.label_gain = np.asarray(config.label_gain, dtype=np.float32)
        self.optimize_pos_at = int(config.max_position)
        self.weights = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        if metadata.query_boundaries is None:
            log.fatal("For lambdarank tasks, should have query information")
        label = np.asarray(metadata.label)
        boundaries = np.asarray(metadata.query_boundaries, np.int64)
        nq = boundaries.size - 1
        sizes = np.diff(boundaries)
        qmax = int(sizes.max())
        dcg = DCGCalculator(self.label_gain)

        # cached inverse max DCG per query (rank_objective.hpp:53-63)
        inv_max_dcg = np.zeros(nq, dtype=np.float32)
        for q in range(nq):
            lo, hi = boundaries[q], boundaries[q + 1]
            max_dcg = dcg.cal_max_dcg_at_k(self.optimize_pos_at, label[lo:hi])
            inv_max_dcg[q] = 1.0 / max_dcg if max_dcg > 0 else max_dcg

        # row -> its place in the padded [nq, qmax] layout, and back
        query = np.repeat(np.arange(nq), sizes)
        pos = query * qmax + np.arange(num_data) - boundaries[query]
        doc_index = np.zeros(nq * qmax, dtype=np.int64)
        doc_index[pos] = np.arange(num_data)
        valid = np.zeros(nq * qmax, dtype=bool)
        valid[pos] = True
        labels = np.zeros(nq * qmax, dtype=np.int64)
        labels[pos] = label.astype(np.int64)

        def dev(a):
            return torch.as_tensor(a, device=device)

        self.row_pos = dev(pos)
        self.doc_index = dev(doc_index.reshape(nq, qmax))
        self.valid = dev(valid.reshape(nq, qmax))
        self.labels = dev(labels.reshape(nq, qmax))
        self.inv_max_dcg = dev(inv_max_dcg)
        self.discount = dev(dcg.discount[:qmax].astype(np.float32))
        self.gains = dev(self.label_gain)
        if metadata.weights is not None:
            self.weights = torch.as_tensor(metadata.weights,
                                           dtype=torch.float32, device=device)
        self.block = max(1, min(nq, (1 << 24) // max(qmax * qmax, 1)))

    def get_gradients(self, score: torch.Tensor):
        """``score`` [N] -> (lambdas, hessians), each [N] f32."""
        s = torch.where(self.valid, score.to(torch.float32)[self.doc_index],
                        -np.inf)
        lam = torch.empty_like(s)
        hes = torch.empty_like(s)
        for b0 in range(0, s.shape[0], self.block):
            b1 = b0 + self.block
            lam[b0:b1], hes[b0:b1] = self._query_block(
                s[b0:b1], self.labels[b0:b1], self.inv_max_dcg[b0:b1])
        lambdas = lam.reshape(-1)[self.row_pos]
        hessians = hes.reshape(-1)[self.row_pos]
        if self.weights is not None:
            lambdas = lambdas * self.weights
            hessians = hessians * self.weights
        return lambdas, hessians

    def _query_block(self, s, labels, inv_max_dcg):
        """Pairwise lambdas of a block of padded queries: ``s`` [b, q] f32
        scores (−inf padding), ``labels`` [b, q] int64 -> [b, q] lambdas
        and hessians in document order."""
        order = torch.argsort(-s, dim=1, stable=True)
        ss = s.gather(1, order)
        ll = labels.gather(1, order)
        cnt = (ss != -np.inf).sum(1)
        best = ss[:, 0]
        worst_idx = (cnt - 1).clamp(min=0)
        at_worst = ss.gather(1, worst_idx[:, None])[:, 0]
        worst_idx = torch.where((worst_idx > 0) & (at_worst == -np.inf),
                                worst_idx - 1, worst_idx)
        worst = ss.gather(1, worst_idx[:, None])[:, 0]

        hi_s, lo_s = ss[:, :, None], ss[:, None, :]
        hi_l, lo_l = ll[:, :, None], ll[:, None, :]
        gl = self.gains[ll]
        disc = self.discount
        paired_disc = (disc[:, None] - disc[None, :]).abs()
        delta = hi_s - lo_s
        delta_ndcg = (gl[:, :, None] - gl[:, None, :]) * paired_disc \
            * inv_max_dcg[:, None, None]
        delta_ndcg = torch.where(
            (hi_l != lo_l) & (best != worst)[:, None, None],
            delta_ndcg / (0.01 + delta.abs()), delta_ndcg)
        sig = 2.0 / (1.0 + torch.exp((2.0 * delta * self._sigmoid)
                                     .to(torch.float64)).to(torch.float32))
        del delta
        pair = (hi_l > lo_l) & (hi_s != -np.inf) & (lo_s != -np.inf)
        lam = torch.where(pair, -sig * delta_ndcg, 0.0)
        hes = torch.where(pair, 2.0 * delta_ndcg * (sig * (2.0 - sig)), 0.0)
        del sig, delta_ndcg, pair
        f64, f32 = torch.float64, torch.float32
        lam_sorted = (lam.sum(2, dtype=f64) - lam.sum(1, dtype=f64)).to(f32)
        hes_sorted = (hes.sum(2, dtype=f64) + hes.sum(1, dtype=f64)).to(f32)
        # back from score order to document order
        return (torch.empty_like(lam_sorted).scatter_(1, order, lam_sorted),
                torch.empty_like(hes_sorted).scatter_(1, order, hes_sorted))

    @property
    def sigmoid(self) -> float:
        # ranking scores are used raw at predict time
        # (rank_objective.hpp:194-199)
        return -1.0
