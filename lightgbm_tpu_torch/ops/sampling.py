"""Row sampling on the training device: bagging mask draws and GOSS.

Counterpart of lightgbm_tpu/ops/sampling.py:42-133, on the port's own
threefry (utils/threefry.py), so each draw is the JAX package's bit for
bit:

- **Bagging** (``bag_mask_for_draw``): the ``draw_index``-th redraw keys
  ``fold_in(PRNGKey(bagging_seed), draw_index)``, draws one float32
  uniform per row and keeps the ``bag_cnt`` rows of the smallest ones —
  exactly ``int(bagging_fraction * n)`` rows in-bag.  The argsort is
  stable, as ``jnp.argsort`` is: ties among 2^23 float32 values in [0, 1)
  are common at a million rows, and break by row index.
- **GOSS** (``goss_select``): rows ranked by their absolute gradient
  summed over the classes (stable, descending), the ``top_cnt`` first
  kept, ``other_cnt`` of the rest drawn uniformly, and those drawn rows'
  gradients and hessians amplified by ``(1 - top_rate) / other_rate``.
"""
from __future__ import annotations

import torch

from ..utils import threefry


def bag_key(bagging_seed: int) -> threefry.Key:
    """The base key of the device bagging stream."""
    return threefry.prng_key(bagging_seed)


def bag_mask_for_draw(base_key: threefry.Key, draw_index: int,
                      num_rows: int, bag_cnt: int,
                      device=None) -> torch.Tensor:
    """[num_rows] bool in-bag mask of the ``draw_index``-th redraw of the
    stream rooted at ``base_key``: exactly ``bag_cnt`` rows in-bag."""
    u = threefry.uniform(threefry.fold_in(base_key, draw_index), num_rows,
                         device)
    order = torch.argsort(u, stable=True)
    mask = torch.zeros(num_rows, dtype=torch.bool, device=u.device)
    mask[order[:bag_cnt]] = True
    return mask


def goss_row_scores(grad: torch.Tensor) -> torch.Tensor:
    """[N] f32: the absolute gradient summed over the classes of a [K, N]
    gradient, class by class in order, as XLA reduces the class axis."""
    grad = grad.to(torch.float32)
    out = grad[0].abs()
    for k in range(1, grad.shape[0]):
        out = out + grad[k].abs()
    return out


def goss_mask_weights(key: threefry.Key, absg: torch.Tensor, top_cnt: int,
                      other_cnt: int, amp: float):
    """(mask [n] bool, w [n] f32) of one GOSS draw over the row scores:
    the ``top_cnt`` rows of the largest scores, ``other_cnt`` rows drawn
    uniformly from the rest, ``w`` = amp on the drawn rows and 1
    elsewhere."""
    n = absg.shape[0]
    order = torch.argsort(-absg, stable=True)
    mask = torch.zeros(n, dtype=torch.bool, device=absg.device)
    mask[order[:top_cnt]] = True
    rest = order[top_cnt:]
    u = threefry.uniform(key, n - top_cnt, absg.device)
    pick = rest[torch.argsort(u, stable=True)[:other_cnt]]
    mask[pick] = True
    w = torch.ones(n, dtype=torch.float32, device=absg.device)
    w[pick] = torch.tensor(amp, dtype=torch.float32)
    return mask, w


def goss_select(key: threefry.Key, grad: torch.Tensor, hess: torch.Tensor,
                top_cnt: int, other_cnt: int, amp: float):
    """GOSS over [K, N] gradients: (grad', hess', mask), grad' and hess'
    amplified on the drawn rows (the other unselected rows' values do not
    matter: the mask keeps them out of histograms and root sums)."""
    mask, w = goss_mask_weights(key, goss_row_scores(grad), int(top_cnt),
                                int(other_cnt), float(amp))
    return grad * w, hess * w, mask


def goss_counts(num_rows: int, top_rate: float, other_rate: float):
    """(top_cnt, other_cnt, amp) for a dataset size."""
    top_cnt = int(top_rate * num_rows)
    other_cnt = int(other_rate * num_rows)
    amp = (1.0 - top_rate) / other_rate
    return top_cnt, other_cnt, amp


__all__ = ["bag_key", "bag_mask_for_draw", "goss_counts", "goss_mask_weights",
           "goss_row_scores", "goss_select"]
