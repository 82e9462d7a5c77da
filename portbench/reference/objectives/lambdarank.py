"""Plain float64 LambdaRank NDCG gradients (LightGBM
rank_objective.hpp, without truncation or normalisation): in each query,
documents sorted by score descending (ties keep document order); for
each pair with label(i) > label(j),
``ΔNDCG = (gain_i - gain_j)·|disc_i - disc_j| / maxDCG@max_position``,
divided by ``0.01 + |s_i - s_j|`` when the query's best and worst
scores differ; ``ρ = 2 / (1 + exp(2σ(s_i - s_j)))``; document i gets
``-ρ·ΔNDCG``, document j ``+ρ·ΔNDCG``, both the hessian
``2·ΔNDCG·ρ·(2 - ρ)``.  Gains ``2^label - 1``, discounts
``1 / log2(2 + position)``.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def _max_dcg(labels: np.ndarray, boundaries: np.ndarray, k: int,
             gains: np.ndarray, disc: np.ndarray) -> np.ndarray:
    out = np.zeros(boundaries.size - 1)
    for q in range(out.size):
        top = np.sort(labels[boundaries[q]:boundaries[q + 1]])[::-1][:k]
        out[q] = (gains[top.astype(np.int64)] * disc[:top.size]).sum()
    return out


class LambdaRank:
    """Gradients of every document of a table of queries; queries are
    grouped by length so each group pads only to its own longest."""

    def __init__(self, label: np.ndarray, boundaries: np.ndarray,
                 device, sigmoid: float = 1.0, max_position: int = 20,
                 pairs_per_block: int = 1 << 24):
        self.sigmoid = sigmoid
        sizes = np.diff(boundaries)
        qmax = int(sizes.max())
        gains = 2.0 ** np.arange(32) - 1.0
        disc = 1.0 / np.log2(2.0 + np.arange(qmax))
        mdcg = _max_dcg(label, boundaries, max_position, gains, disc)
        inv = np.where(mdcg > 0, 1.0 / np.where(mdcg > 0, mdcg, 1.0), 0.0)
        self.device = device
        self.n = int(boundaries[-1])
        self.gains = torch.as_tensor(gains, dtype=F64, device=device)
        self.disc = torch.as_tensor(disc, dtype=F64, device=device)
        lab = torch.as_tensor(label.astype(np.int64), device=device)
        order = np.argsort(sizes, kind="stable")
        self.groups = []
        i = 0
        while i < order.size:
            width = int(sizes[order[i]])
            j = i
            # a group: queries of similar length under one pair budget
            while (j < order.size and sizes[order[j]] <= 2 * width + 8
                   and (j - i + 1) * int(sizes[order[j]]) ** 2
                   <= pairs_per_block):
                j += 1
            j = max(j, i + 1)
            qs = order[i:j]
            w = int(sizes[qs].max())
            idx = np.full((qs.size, w), -1, np.int64)
            for r, q in enumerate(qs):
                idx[r, :sizes[q]] = np.arange(boundaries[q], boundaries[q + 1])
            t_idx = torch.as_tensor(idx, device=device)
            valid = t_idx >= 0
            safe = t_idx.clamp(min=0)
            self.groups.append((safe, valid, torch.where(valid, lab[safe], 0),
                                torch.as_tensor(inv[qs], dtype=F64,
                                                device=device)))
            i = j

    def __call__(self, score: torch.Tensor):
        s_all = score.to(F64)
        grad = torch.zeros(self.n, dtype=F64, device=self.device)
        hess = torch.zeros(self.n, dtype=F64, device=self.device)
        for safe, valid, lab, inv in self.groups:
            s = torch.where(valid, s_all[safe], -np.inf)
            order = torch.sort(s, dim=1, descending=True, stable=True).indices
            ss = s.gather(1, order)
            ll = lab.gather(1, order)
            vv = valid.gather(1, order)
            best = ss[:, 0]
            worst = torch.where(vv, ss, np.inf).min(1).values
            w = ss.shape[1]
            disc = self.disc[:w]
            g = self.gains[ll]
            d = ss[:, :, None] - ss[:, None, :]
            pair = ((ll[:, :, None] > ll[:, None, :]) & vv[:, :, None]
                    & vv[:, None, :])
            d = torch.where(pair, d, 0.0)
            ndcg = ((g[:, :, None] - g[:, None, :])
                    * (disc[:, None] - disc[None, :]).abs()
                    * inv[:, None, None])
            ndcg = torch.where((best != worst)[:, None, None],
                               ndcg / (0.01 + d.abs()), ndcg)
            rho = 2.0 / (1.0 + torch.exp(2.0 * self.sigmoid * d))
            lam = torch.where(pair, -rho * ndcg, 0.0)
            hes = torch.where(pair, 2.0 * ndcg * rho * (2.0 - rho), 0.0)
            lam_doc = lam.sum(2) - lam.sum(1)
            hes_doc = hes.sum(2) + hes.sum(1)
            rows = safe.gather(1, order)
            grad.index_put_((rows[vv],), lam_doc[vv])
            hess.index_put_((rows[vv],), hes_doc[vv])
        return grad, hess


def make(table, params: dict, device):
    """score [1, N] -> (gradient, hessian) [1, N], float64."""
    rank = LambdaRank(table.y, table.query_boundaries, device,
                      float(params.get("sigmoid", 1.0)),
                      int(params.get("max_position", 20)))

    def gradients(score):
        g, h = rank(score[0])
        return g[None], h[None]
    return gradients


def pairs(table) -> int:
    """Document pairs of different labels within a query: the gradient's
    work beyond its pass over the rows (cost.objective_s)."""
    qb = table.query_boundaries
    y = table.y.astype(np.int64)
    q = np.repeat(np.arange(qb.size - 1), np.diff(qb))
    cnt = np.zeros((qb.size - 1, int(y.max()) + 1), np.int64)
    np.add.at(cnt, (q, y), 1)
    tot = cnt.sum(1)
    same = (cnt * cnt).sum(1)
    return int(((tot * tot - same) // 2).sum())
