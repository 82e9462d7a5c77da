"""Training health: numerical health on the device, policy on the host.

The port of lightgbm_tpu/health.py.  The telemetry registry records what
the host does; this module watches what the training arrays hold.  A NaN
gradient, an Inf score, int8 quantization piling onto its ±127 ceiling
or a tree of zero-gain splits degrade a model silently; nothing in the
phase timers moves.

1. **Never perturb training.**  :func:`health_vector` reduces the
   gradients, hessians and scores the iteration already holds with torch
   reductions and feeds nothing back, so a run with health on grows the
   same trees bit for bit as one with it off.
2. **One host read an iteration, at most.**  The [8] vector is stacked
   on the device and copied to the host once (``.cpu()``), beside the
   tree readback the boosting loop already pays; the tree-derived counts
   come from the host trees.

:class:`HealthMonitor` assembles each iteration's ``health`` block,
applies ``on_anomaly`` (``warn`` / ``halt`` / ``record``), tracks
eval-metric divergence (``health_divergence_rounds`` consecutive
worsening iterations) and mirrors anomaly totals into telemetry counters
(``health/<kind>``).  The JAX package's fused-chunk closure
(``make_health_fn``) has no counterpart: the port has no chunk programs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import telemetry
from .ops.hist_cuda import quant_saturation_count
from .utils import log

# Device health-vector layout: indices 0..5 are counts, 6 the int8
# saturation gauge, 7 a watermark
HEALTH_VEC_KEYS = (
    "grad_nan", "grad_inf", "hess_nan", "hess_inf",
    "score_nan", "score_inf", "quant_sat",
    "score_max_abs",
)

# Tree-derived keys appended on the host
TREE_HEALTH_KEYS = ("zero_gain_splits", "empty_leaves", "degenerate_trees")

# Keys whose nonzero value is an anomaly under the on_anomaly policy;
# quant_sat and the zero-gain / empty-leaf counts are gauges: the int8
# scale pins its max row at the ceiling by construction, and zero-gain
# nodes appear in healthy late training
ANOMALY_KEYS = ("grad_nan", "grad_inf", "hess_nan", "hess_inf",
                "score_nan", "score_inf")


class TrainingHealthError(log.LightGBMError):
    """Raised by ``on_anomaly=halt``: a clean, catchable stop (the CLI
    exits 1 on it, as on every LightGBMError)."""


def health_vector(grad, hess, score, *, quantized: bool = False):
    """[8] f32 tensor on the arrays' device (HEALTH_VEC_KEYS): grad/hess
    [K, N] (or [N]) gradients and hessians, score [K, N] raw scores after
    this iteration's update.  ``quantized`` adds the int8 saturation
    gauge (``hist_cuda.quant_saturation_count``)."""
    f32 = torch.float32

    def cnt(pred):
        return pred.to(f32).sum()

    parts = [cnt(torch.isnan(grad)), cnt(torch.isinf(grad)),
             cnt(torch.isnan(hess)), cnt(torch.isinf(hess)),
             cnt(torch.isnan(score)), cnt(torch.isinf(score))]
    parts.append(quant_saturation_count(grad, hess) if quantized
                 else torch.zeros((), dtype=f32, device=grad.device))
    # watermark over finite scores only: a NaN would poison the max and
    # hide the magnitude trend that precedes overflow
    finite = torch.isfinite(score)
    parts.append(torch.where(finite, score.abs(),
                             torch.zeros((), dtype=score.dtype,
                                         device=score.device)).max().to(f32))
    return torch.stack(parts)


def tree_health_counts(num_leaves: int, split_gain, leaf_count) -> dict:
    """Zero- or negative-gain splits, empty leaves and whether the tree
    is degenerate (an unsplit root), from a host tree."""
    n = int(num_leaves)
    zero_gain = int(np.sum(np.asarray(split_gain)[:max(n - 1, 0)] <= 0.0))
    empty = int(np.sum(np.asarray(leaf_count)[:n] == 0)) if n > 1 else 0
    return {"zero_gain_splits": zero_gain, "empty_leaves": empty,
            "degenerate_trees": int(n <= 1)}


def resolve_enabled(health_setting: str) -> bool:
    """``health=``: "auto" follows the telemetry registry (armed
    telemetry turns the monitor on); "true"/"false" force it."""
    if health_setting == "true":
        return True
    if health_setting == "false":
        return False
    return telemetry.enabled()


class HealthMonitor:
    """Per-booster health state: assembles iteration blocks, applies the
    ``on_anomaly`` policy, tracks eval-metric divergence.  Host-side
    bookkeeping over a host copy of the device vector and the host
    trees."""

    def __init__(self, on_anomaly: str = "warn",
                 divergence_rounds: int = 0, quantized: bool = False):
        self.on_anomaly = on_anomaly
        self.divergence_rounds = int(divergence_rounds)
        self.quantized = bool(quantized)
        self.totals: Dict[str, float] = {}
        self.anomalous_iterations = 0
        self._iter_tree: Dict[str, int] = {}
        self._warned: set = set()
        self._eval_last: Dict[str, float] = {}
        self._eval_streak: Dict[str, int] = {}
        self._pending_divergence: list = []

    def vector(self, grad, hess, score):
        """This iteration's [8] device vector (``health_vector``)."""
        return health_vector(grad, hess, score, quantized=self.quantized)

    def add_tree(self, num_leaves: int, split_gain, leaf_count) -> None:
        """Fold one tree into the current iteration's counts."""
        for k, v in tree_health_counts(num_leaves, split_gain,
                                       leaf_count).items():
            self._iter_tree[k] = self._iter_tree.get(k, 0) + v

    def observe_eval(self, key: str, value: float,
                     bigger_better: bool) -> None:
        """Track one eval metric value; ``divergence_rounds`` consecutive
        worsening iterations flag an ``eval_divergence`` anomaly."""
        if self.divergence_rounds <= 0:
            return
        last = self._eval_last.get(key)
        self._eval_last[key] = value
        if last is None:
            return
        if value != value:          # NaN metric: the most extreme
            worse = True            # divergence, not a streak reset
        elif last != last:
            worse = False           # recovery from NaN re-arms the streak
        else:
            worse = value < last if bigger_better else value > last
        streak = self._eval_streak.get(key, 0) + 1 if worse else 0
        self._eval_streak[key] = streak
        if streak >= self.divergence_rounds:
            self._pending_divergence.append((key, streak, last, value))
            self._eval_streak[key] = 0   # re-arm, don't re-fire every iter

    def assemble(self, vec) -> dict:
        """The iteration's ``health`` block from the host vector (or None
        when the iteration produced no gradients) and the tree counts.
        Resets the per-iteration tree state."""
        block: Dict[str, float] = {}
        if vec is not None:
            vals = np.asarray(vec, np.float64)
            for i, k in enumerate(HEALTH_VEC_KEYS):
                block[k] = (float(vals[i]) if k == "score_max_abs"
                            else int(vals[i]))
        for k in TREE_HEALTH_KEYS:
            block[k] = self._iter_tree.get(k, 0)
        self._iter_tree = {}
        if self._pending_divergence:
            block["eval_divergence"] = [
                {"metric": k, "rounds": s,
                 "from": round(a, 6), "to": round(b, 6)}
                for k, s, a, b in self._pending_divergence]
        for k, v in block.items():
            if k == "eval_divergence":
                continue
            if k == "score_max_abs":
                self.totals[k] = max(self.totals.get(k, 0.0), v)
            else:
                self.totals[k] = self.totals.get(k, 0) + v
        return block

    def anomalies(self, block: dict) -> list:
        out = [k for k in ANOMALY_KEYS if block.get(k, 0)]
        out += ["eval_divergence:" + d["metric"]
                for d in block.get("eval_divergence", ())]
        return out

    def apply_policy(self, block: dict, iteration: int) -> None:
        """warn / halt / record on the iteration's anomalies; counters
        mirror every anomaly (``health/<kind>``) whatever the policy."""
        found = self.anomalies(block)
        self._pending_divergence = []
        if not found:
            return
        self.anomalous_iterations += 1
        telemetry.count("health/anomalous_iterations")
        for kind in found:
            telemetry.count("health/" + kind.split(":")[0])
        detail = ", ".join(
            "%s=%s" % (k, block.get(k)) for k in ANOMALY_KEYS
            if block.get(k, 0))
        if block.get("eval_divergence"):
            detail = (detail + ("; " if detail else "")
                      + "eval divergence: " + ", ".join(
                          "%s (%d rounds)" % (d["metric"], d["rounds"])
                          for d in block["eval_divergence"]))
        if self.on_anomaly == "halt":
            log.error("training health anomaly at iteration %d (%s); "
                      "on_anomaly=halt — stopping" % (iteration, detail))
            raise TrainingHealthError(
                "training halted by health monitor at iteration %d: %s"
                % (iteration, detail))
        if self.on_anomaly == "warn":
            key = tuple(sorted(set(k.split(":")[0] for k in found)))
            if key not in self._warned:
                self._warned.add(key)
                log.warning("training health anomaly at iteration %d (%s); "
                            "recording every iteration, warning once per "
                            "anomaly kind (on_anomaly=warn)"
                            % (iteration, detail))

    def summary(self) -> dict:
        """Cumulative totals (the summary record's ``health`` block)."""
        out = dict(self.totals)
        out["anomalous_iterations"] = self.anomalous_iterations
        return out
