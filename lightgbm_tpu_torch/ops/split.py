"""Best-split search over histograms, in torch.

Counterpart of lightgbm_tpu/ops/split.py:36-205 (FindBestThreshold,
feature_histogram.hpp:106-165) with the same semantics:

- threshold t means "bin <= t goes left"; candidates 0 .. num_bin-2;
- kEpsilon hessian padding: total +2ε, each side +ε;
- both sides need ``min_data_in_leaf`` rows and
  ``min_sum_hessian_in_leaf`` hessian mass, and gain >= the parent's;
- the reported gain is ``best - gain_shift``; split gain g²/h, output -g/h;
- ties: within a feature the LARGER threshold wins (argmax over the
  reversed threshold axis, split.py:161-167); across features the SMALLER
  index wins (``torch.argmax`` returns the first maximum on the CPU and on
  CUDA alike).

One difference: the cumulative sums over bins run in float64 and round
to f32.  A float32 ``torch.cumsum`` associates differently on CUDA than
on the CPU, and a split decided by that last bit would make the two
devices grow different trees; in f64 the int8 mode's sums are exact.

Batched: ``hist`` may carry leading dimensions (both children of a split
are searched in one call), with matching leading dims on the totals.

``per_feature_best_scores`` (split.py:136-148) is each feature's best
score alone, for the voting learner's vote.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15  # meta.h kEpsilon
NUM_FIELDS = 11


class SplitResult(NamedTuple):
    """SplitInfo (split_info.hpp:17-54); tensors of the batch shape."""
    gain: torch.Tensor            # f32; -inf when unsplittable
    feature: torch.Tensor         # int64 inner feature index
    threshold: torch.Tensor       # int64 bin threshold
    left_output: torch.Tensor
    right_output: torch.Tensor
    left_count: torch.Tensor      # int32
    right_count: torch.Tensor
    left_sum_grad: torch.Tensor
    left_sum_hess: torch.Tensor   # raw (no epsilon)
    right_sum_grad: torch.Tensor
    right_sum_hess: torch.Tensor

    def packed(self) -> torch.Tensor:
        """[..., 11] f32 — one tensor, so the host reads a split in one
        copy (indices and counts are exact in f32 below 2^24)."""
        return torch.stack([x.to(torch.float32) for x in self], dim=-1)


def _leaf_split_gain(g, h):
    return (g * g) / h


def _threshold_scan(hist, sum_grad, sum_hess, num_data, num_bins,
                    feature_mask, min_data_in_leaf: float,
                    min_sum_hessian_in_leaf: float):
    """Every threshold's left sums and score (split.py:86-133): (cg, ch,
    cc, score [..., F, B], gain_shift [..., 1, 1]); ``num_bins`` and
    ``feature_mask`` are [F] or carry the batch dims too ([..., F])."""
    B = hist.shape[-2]
    f32 = torch.float32
    eps = torch.tensor(K_EPSILON, dtype=f32, device=hist.device)
    csum = torch.cumsum(hist.to(torch.float64), dim=-2).to(f32)
    cg, ch, cc = csum[..., 0], csum[..., 1], csum[..., 2]   # [..., F, B]
    total_g = sum_grad.to(f32)[..., None, None]
    total_h = sum_hess.to(f32)[..., None, None]
    total_c = num_data.to(f32)[..., None, None]

    left_h = ch + eps
    right_g = total_g - cg
    right_h = (total_h - ch) + eps
    right_c = total_c - cc
    thresholds = torch.arange(B, device=hist.device)
    valid = ((right_c >= min_data_in_leaf)
             & (cc >= min_data_in_leaf)
             & (right_h >= min_sum_hessian_in_leaf)
             & (left_h >= min_sum_hessian_in_leaf)
             & (thresholds <= (num_bins[..., None] - 2))
             & feature_mask[..., None])
    gain_shift = _leaf_split_gain(total_g, total_h + 2 * eps)
    current = _leaf_split_gain(cg, left_h) + _leaf_split_gain(right_g,
                                                              right_h)
    valid = valid & (current >= gain_shift)
    score = torch.where(valid, current,
                        torch.tensor(float("-inf"), dtype=f32,
                                     device=hist.device))
    return cg, ch, cc, score, gain_shift


def per_feature_best_scores(hist, sum_grad, sum_hess, num_data, num_bins,
                            feature_mask, min_data_in_leaf: float,
                            min_sum_hessian_in_leaf: float) -> torch.Tensor:
    """[..., F] each feature's best (unshifted) split score, -inf where no
    threshold passes ``min_data_in_leaf``, ``min_sum_hessian_in_leaf`` or
    the parent's gain (split.py:136-148): the voting learner's local
    gains, by which each data shard proposes its top-k features."""
    return _threshold_scan(hist, sum_grad, sum_hess, num_data, num_bins,
                           feature_mask, min_data_in_leaf,
                           min_sum_hessian_in_leaf)[3].max(-1).values


def find_best_split(hist, sum_grad, sum_hess, num_data, num_bins,
                    feature_mask, min_data_in_leaf: float,
                    min_sum_hessian_in_leaf: float) -> SplitResult:
    """hist [..., F, B, 3] f32; sum_grad/sum_hess/num_data [...] f32 leaf
    totals (raw); num_bins [F] int and feature_mask [F] bool, or each
    with the batch dims ([..., F]: a batch of different feature sets)."""
    B = hist.shape[-2]
    f32 = torch.float32
    eps = torch.tensor(K_EPSILON, dtype=f32, device=hist.device)
    cg, ch, cc, score, gain_shift = _threshold_scan(
        hist, sum_grad, sum_hess, num_data, num_bins, feature_mask,
        min_data_in_leaf, min_sum_hessian_in_leaf)
    total_g = sum_grad.to(f32)[..., None, None]
    total_h = sum_hess.to(f32)[..., None, None]
    total_c = num_data.to(f32)[..., None, None]

    best_t = (B - 1) - torch.argmax(torch.flip(score, dims=(-1,)), dim=-1)
    best_score = torch.gather(score, -1, best_t[..., None])[..., 0]
    best_f = torch.argmax(best_score, dim=-1)                   # [...]
    pick = lambda x: torch.gather(x, -1, best_f[..., None])[..., 0]
    gain_raw = pick(best_score)
    t = pick(best_t)

    def at(x):                       # x [..., F, B] -> value at (best_f, t)
        row = torch.gather(x, -2, best_f[..., None, None].expand(
            *best_f.shape, 1, B))[..., 0, :]
        return torch.gather(row, -1, t[..., None])[..., 0]

    lg, lh_raw, lc = at(cg), at(ch), at(cc)
    tg, th, tc = total_g[..., 0, 0], total_h[..., 0, 0], total_c[..., 0, 0]
    rg, rh_raw, rc = tg - lg, th - lh_raw, tc - lc
    shift = gain_shift[..., 0, 0]
    gain = torch.where(torch.isfinite(gain_raw), gain_raw - shift,
                       torch.full_like(gain_raw, float("-inf")))
    return SplitResult(
        gain=gain, feature=best_f, threshold=t,
        left_output=-lg / (lh_raw + eps),
        right_output=-rg / (rh_raw + eps),
        left_count=lc.to(torch.int32), right_count=rc.to(torch.int32),
        left_sum_grad=lg, left_sum_hess=lh_raw,
        right_sum_grad=rg, right_sum_hess=rh_raw)
