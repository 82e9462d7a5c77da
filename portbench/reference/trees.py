"""Plain float64 best-first tree search, and the walk of trees over rows.

``replay`` follows one tree that the program grew, split by split, and
judges each decision against a histogram search of its own: at every
step the open leaves, their rows, their histograms over the table's own
level codes and their best splits are the reference's, computed from
the gradients it is given.  It returns

- ``split_gap``: the largest shortfall of the program's chosen split
  (leaf, column and cut) below the best gain among all open leaves, as a
  share of the largest unshifted split score among them; a split that
  the reference finds inadmissible counts 1.  A tree that stopped with a
  leaf whose best gain is positive counts that gain the same way.
- ``root_gain``: the reference's gain of the program's root split;
- ``leaf_values``: each leaf's ``-G/H`` times the learning rate over the
  rows the reference routed to it.
- ``assign``: per leaf, the rows the reference routed there.

The split rule is LightGBM's (feature_histogram.hpp): a cut ``t`` sends
code ``<= t`` left; both sides need ``min_data_in_leaf`` rows and
``min_sum_hessian_in_leaf`` hessian mass; the score is
``G_L²/H_L + G_R²/H_R`` and the gain that score less ``G²/H``.  The
hessian limit has a relative margin ``HESS_MARGIN`` on each side: the
reference's best is taken over cuts clear of the limit by the margin,
and the program's cut is admissible unless it falls short by it, so a
cut that float32 and float64 sums place on opposite sides of the limit
decides nothing.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

F64 = torch.float64
HESS_MARGIN = 1e-5
# rows a histogram chunk gathers at once, times the column count
CHUNK_ELEMS = 1 << 26


class Split(NamedTuple):
    gain: float          # best shifted gain, -inf when none is admissible
    score: float         # its unshifted score
    feature: int
    cut: int


class Histogrammer:
    """[F, B, 3] float64 (gradient, hessian, count) histograms of row
    sets over ``codes`` [F, N] (uint8 level codes on the device)."""

    def __init__(self, codes: torch.Tensor, levels: np.ndarray):
        self.codes = codes
        self.F, self.N = codes.shape
        self.B = int(levels.max())
        self.levels = torch.as_tensor(levels, device=codes.device)
        self.offsets = (torch.arange(self.F, device=codes.device)
                        * self.B)[:, None]

    def __call__(self, idx, grad, hess) -> torch.Tensor:
        F, B = self.F, self.B
        n = self.N if idx is None else idx.numel()
        out = torch.zeros(3, F * B, dtype=F64, device=self.codes.device)
        step = max(1, CHUNK_ELEMS // F)
        for a in range(0, n, step):
            if idx is None:
                c = self.codes[:, a:a + step]
                g, h = grad[a:a + step], hess[a:a + step]
            else:
                rows = idx[a:a + step]
                c = self.codes[:, rows]
                g, h = grad[rows], hess[rows]
            key = (c.long() + self.offsets).reshape(-1)
            m = c.shape[1]
            out[0] += torch.bincount(key, g.expand(F, m).reshape(-1), F * B)
            out[1] += torch.bincount(key, h.expand(F, m).reshape(-1), F * B)
            out[2] += torch.bincount(key, minlength=F * B).to(F64)
        return out.reshape(3, F, B).permute(1, 2, 0)


def scores(hist: torch.Tensor, levels: torch.Tensor, min_data: float,
           min_hess: float, margin: float):
    """(score [F, B] with -inf where inadmissible, shift) of every cut."""
    cum = torch.cumsum(hist, dim=1)
    cg, ch, cc = cum[..., 0], cum[..., 1], cum[..., 2]
    G, H, C = cum[0, -1, 0], cum[0, -1, 1], cum[0, -1, 2]
    rg, rh, rc = G - cg, H - ch, C - cc
    lim = min_hess * (1.0 + margin)
    cut = torch.arange(hist.shape[1], device=hist.device)
    ok = ((ch >= lim) & (rh >= lim) & (cc >= min_data) & (rc >= min_data)
          & (cut[None, :] <= levels[:, None] - 2))
    sc = cg * cg / ch.clamp(min=1e-300) + rg * rg / rh.clamp(min=1e-300)
    return torch.where(ok, sc, -torch.inf), G * G / H


def best_split(hist, levels, min_data, min_hess) -> Split:
    sc, shift = scores(hist, levels, min_data, min_hess, HESS_MARGIN)
    flat = int(torch.argmax(sc))
    best = float(sc.reshape(-1)[flat])
    if not np.isfinite(best):
        return Split(-np.inf, 0.0, -1, -1)
    return Split(best - float(shift), best, flat // sc.shape[1],
                 flat % sc.shape[1])


def gain_of(hist, levels, min_data, min_hess, feature, cut) -> float:
    """The shifted gain of one cut, -inf when inadmissible even with the
    margin given to the program."""
    sc, shift = scores(hist, levels, min_data, min_hess, -HESS_MARGIN)
    return float(sc[feature, cut] - shift)


class Replay(NamedTuple):
    split_gap: float
    root_gain: float               # the reference's gain of the root split
    leaf_values: np.ndarray        # [L] float64, times the learning rate
    assign: List[torch.Tensor]     # per leaf, its rows


def parents(left_child: np.ndarray, right_child: np.ndarray):
    """(parent, side) of every internal node; the root's parent -1."""
    n = left_child.size
    par = np.full(n, -1, np.int64)
    side = np.zeros(n, np.int64)
    for p in range(n):
        for sd, c in ((0, left_child[p]), (1, right_child[p])):
            if c >= 0:
                par[c], side[c] = p, sd
    return par, side


def replay(hister: Histogrammer, grad, hess, split_feature, cut,
           left_child, right_child, leaf_value, num_leaves_max: int,
           learning_rate: float, min_data: float, min_hess: float) -> Replay:
    """Follow the program's tree (``split_feature`` raw columns, ``cut``
    level cuts, the children in the model's encoding, ``leaf_value`` its
    leaves) over the gradients ``grad``/``hess`` [N] float64."""
    L = leaf_value.size
    lv = hister.levels
    par, side = parents(left_child, right_child)
    root = torch.arange(hister.N, device=grad.device)
    open_ = {0: (root, hister(None, grad, hess))}
    best = {0: best_split(open_[0][1], lv, min_data, min_hess)}
    gap, root_gain = 0.0, np.nan
    for s in range(L - 1):
        slot = 0 if s == 0 else 2 * int(par[s]) + 1 + int(side[s])
        if slot not in open_:
            return Replay(1.0, np.nan, np.zeros(L), [])
        top = max(b.gain for b in best.values())
        den = max(b.score for b in best.values())
        idx, hist = open_.pop(slot)
        f, t = int(split_feature[s]), int(cut[s])
        g = gain_of(hist, lv, min_data, min_hess, f, t)
        if s == 0:
            root_gain = g
        if not np.isfinite(g):
            gap = max(gap, 1.0)
        elif den > 0:
            gap = max(gap, max(top - g, 0.0) / den)
        del best[slot]
        go_left = hister.codes[f, idx].long() <= t
        li, ri = idx[go_left], idx[~go_left]
        small_left = li.numel() <= ri.numel()
        sh = hister(li if small_left else ri, grad, hess)
        kids = (sh, hist - sh) if small_left else (hist - sh, sh)
        for k, (rows, h) in enumerate(((li, kids[0]), (ri, kids[1]))):
            open_[2 * s + 1 + k] = (rows, h)
            best[2 * s + 1 + k] = best_split(h, lv, min_data, min_hess)
    if L < num_leaves_max and best:
        top = max(b.gain for b in best.values())
        den = max(b.score for b in best.values())
        if np.isfinite(top) and top > 0 and den > 0:
            gap = max(gap, top / den)
    values = np.zeros(L)
    assign = [None] * L
    for slot, (rows, h) in open_.items():
        if slot == 0:
            leaf = 0
        else:
            p, k = (slot - 1) // 2, (slot - 1) % 2
            leaf = ~int((left_child if k == 0 else right_child)[p])
        G, H = float(h[0, :, 0].sum()), float(h[0, :, 1].sum())
        values[leaf] = -G / H * learning_rate if H > 0 else 0.0
        assign[leaf] = rows
    return Replay(gap, root_gain if L > 1 else np.nan, values, assign)


def level_cuts(grids, split_feature, threshold) -> np.ndarray:
    """The level cut of each real threshold: levels <= threshold go left."""
    return np.array([np.searchsorted(grids[f].astype(np.float64), t,
                                     side="right") - 1
                     for f, t in zip(split_feature, threshold)], np.int64)


def walk_codes(codes: torch.Tensor, split_feature, cut, left_child,
               right_child, leaf_value) -> torch.Tensor:
    """[N] float64 leaf value of every row of ``codes`` [F, N] in one
    tree, by a lockstep walk."""
    dev = codes.device
    N = codes.shape[1]
    if left_child.size == 0:
        return torch.full((N,), float(leaf_value[0]), dtype=F64, device=dev)
    sf = torch.as_tensor(split_feature, dtype=torch.long, device=dev)
    ct = torch.as_tensor(cut, dtype=torch.long, device=dev)
    lc = torch.as_tensor(left_child, dtype=torch.long, device=dev)
    rc = torch.as_tensor(right_child, dtype=torch.long, device=dev)
    rows = torch.arange(N, device=dev)
    flat = codes.reshape(-1)
    node = torch.zeros(N, dtype=torch.long, device=dev)
    while True:
        live = node >= 0
        if not bool(live.any()):
            break
        nd = node.clamp(min=0)
        c = flat[sf[nd] * N + rows].long()
        nxt = torch.where(c <= ct[nd], lc[nd], rc[nd])
        node = torch.where(live, nxt, node)
    vals = torch.as_tensor(leaf_value, dtype=F64, device=dev)
    return vals[~node]


def walk_values(x: torch.Tensor, split_feature, threshold, left_child,
                right_child, leaf_value) -> torch.Tensor:
    """[N] float64 sums over an ensemble ([T, L-1] node arrays, [T, L]
    leaves) of raw rows ``x`` [N, F] float64: a value ``<=`` the
    threshold goes left.  Lockstep over trees and depth."""
    dev = x.device
    N, F = x.shape
    T = split_feature.shape[0]
    sf = torch.as_tensor(split_feature, dtype=torch.long, device=dev)
    th = torch.as_tensor(threshold, dtype=F64, device=dev)
    lc = torch.as_tensor(left_child, dtype=torch.long, device=dev)
    rc = torch.as_tensor(right_child, dtype=torch.long, device=dev)
    lv = torch.as_tensor(leaf_value, dtype=F64, device=dev)
    xt = x.t().contiguous().reshape(-1)
    rows = torch.arange(N, device=dev)[None, :]
    node = torch.zeros((T, N), dtype=torch.long, device=dev)
    while True:
        live = node >= 0
        if not bool(live.any()):
            break
        nd = node.clamp(min=0)
        f = sf.gather(1, nd)
        v = xt[f * N + rows]
        go_left = v <= th.gather(1, nd)
        nxt = torch.where(go_left, lc.gather(1, nd), rc.gather(1, nd))
        node = torch.where(live, nxt, node)
    return lv.gather(1, ~node).sum(0)
