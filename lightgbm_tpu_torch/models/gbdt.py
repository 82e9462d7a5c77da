"""GBDT boosting loop, in torch — the serial per-iteration subset of
lightgbm_tpu/models/gbdt.py.

Ported: ``init``, ``add_valid_dataset``, ``train_one_iter`` (:1141-1319
without pipelining), ``run_training``'s per-iteration loop,
``output_metric`` with early stopping, ``save_model_to_file``
(withholding the early-stopping window, and the ``score_reference=``
line at finish), ``models_from_string``, ``from_model_file``,
``predict_raw``, ``predict``, ``predict_multiclass``,
``feature_importance``, and ``export_flat`` / ``serving_engine`` /
``predict_leaf_index`` over the serving engine (serving.py); and the
sampling state: bagging (a numpy draw per record or per query, or the
threefry device draw, ops/sampling.py), ``feature_fraction`` (one numpy
stream per class) and GOSS, each feeding the growers' row and feature
masks.  The score starts from the training set's initial scores when it
has them (an ``input_init_score`` file, or continued training).  Trees
grow under the policy that ``grow_policy`` and ``leafwise_compact``
select, as in the JAX package's ``_serial_learner`` (:2945-2984):
depth-wise, masked leaf-wise, or compacted leaf-wise, which is what
``leafwise_compact=auto`` resolves to on an accelerator there
(models/grower_unified.py), with the histogram mode of ``hist_dtype``
and ``quant_rounding`` (``TreeConfig.compute_dtype``).  Where the
training set mixes narrow and wide features and ``mixed_bin`` allows
it, the booster keeps its own copy of the bin matrix packed into
bin-width classes (``_pack_spec``, gbdt.py:182-219, 455-462); the
dataset, validation scoring and the trees stay in canonical order.
Single-process checkpoints (:701-1000, the serial non-pipelined branch):
``checkpoint_state`` snapshots the trees, scores, sampler state and
early-stopping state, ``restore_checkpoint`` continues a fresh booster
from one bit for bit, and ``run_training`` writes them every
``checkpoint_interval`` iterations (checkpoint.py) and fires the fault
hatch (faults.py) at each iteration boundary.

Observability on one process (:1171-1307, :1520-1720): the iteration's
phases run under telemetry spans (``gradient``, ``bagging``, ``goss``,
``grow``, ``score_update``, ``valid_update``, ``model_readback``,
``eval``; the growers add ``histogram``, ``split_find`` and
``partition``), one record a iteration goes to the ``metrics_out`` sink
with the ``health`` block of health.py (its one host read an iteration
taken beside the last class's tree) and the memory gauges, the summary
record ends the run (also on an exception, marked ``aborted``, before
the flight recorder's crash dump), ``run_training`` checks in with the
stall watchdog, and the layout and bagging routes are counted once a
booster.  None of it moves a tree.  The fused chunk programs, the
deferred-readback pipeline and the elastic monitor are not ported;
their telemetry goes with them.

The score is a [K, N] f32 tensor on the training device (K = num_class,
1 unless the objective is multiclass); gradients, histograms, partitions
and score updates run there, and the host holds the trees and the
metrics.  Each iteration grows K trees, ``models[iter * K + k]`` for
class k, as gbdt.cpp:175-195.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import checkpoint, faults, health, telemetry, tracing
from ..device import resolve_device
from ..ops import sampling
from ..ops.bins import to_tensor as bins_to_tensor
from ..ops.histogram import is_int8
from ..ops.scoring import add_tree_score, train_score_update
from ..serving import FlatEnsemble, ServingEngine
from ..utils import log, threefry
from .grower_unified import grow_tree_unified
from .predictor import predict_raw_scores, softmax_rows
from .tree import Tree


class GBDT:
    def __init__(self):
        self.models: List[Tree] = []
        self.num_class = 1
        self.label_idx = 0
        self.max_feature_idx = 0
        self.sigmoid = -1.0
        self.iter = 0
        self.train_data = None
        self.objective = None
        self.training_metrics = []
        self.valid_datasets = []
        self.valid_metrics = []
        self.best_score = []
        self.best_iter = []
        self.early_stopping_round = 0
        self.device = None
        self._pack_spec = None      # mixed-bin layout of bins_device
        self._saved_model_size = -1
        self._model_file = None
        self._serve_cache = None    # (key, ServingEngine)
        # the checkpoint writer of the latest run_training, closed when it
        # returns (its ``written`` and ``dropped`` counts stay readable)
        self.checkpoint_writer = None
        # the training-time score histogram (monitor.ScoreHistogram dict):
        # the serving drift baseline, written as the model file's
        # ``score_reference=`` line and parsed back from it
        self.score_reference: Optional[dict] = None
        self._health_monitor = None
        self._last_eval_values: dict = {}
        self._residency_filed = False

    # ------------------------------------------------------------------ init

    def init(self, boosting_config, train_data, objective,
             training_metrics=(), device=None) -> None:
        """GBDT::Init (gbdt.cpp:41-89).  ``device``: "cuda" (default; a
        Fatal when there is no card) or "cpu"."""
        self.device = resolve_device(device)
        telemetry.set_device(self.device)
        self.gbdt_config = boosting_config
        self.tree_config = boosting_config.tree_config
        self.train_data = train_data
        self.objective = objective
        self.training_metrics = list(training_metrics)
        self.num_class = boosting_config.num_class
        self.max_feature_idx = train_data.num_total_features - 1
        self.label_idx = train_data.label_idx
        self.sigmoid = objective.sigmoid if objective is not None else -1.0
        self.num_data = train_data.num_data
        self.num_bins_max = int(train_data.num_bins.max())
        self._bin_upper_table = train_data.bin_upper_bounds_matrix()
        self._pack_spec = train_data.plan_packing(self.tree_config.mixed_bin)
        telemetry.count_route("hist_layout", "hist/mixedbin_off"
                              if self._pack_spec is None
                              else "hist/mixedbin_on")
        if self._pack_spec is None:
            self.bins_device = train_data.to_device(self.device)["bins"]
        else:
            spec = self._pack_spec
            log.info("mixed-bin packing: %d narrow (<=%d bins) + %d wide "
                     "features (histogram passes per class: %s)"
                     % (spec.counts[0], spec.widths[0], spec.counts[1],
                        "x".join(str(w) for w in spec.widths)))
            perm = np.asarray(spec.perm, np.int64)
            if train_data.bins is not None:
                # the booster's own packed copy: the dataset's cached
                # tensor stays canonical for validation sets and other
                # boosters
                self.bins_device = bins_to_tensor(np.ascontiguousarray(
                    train_data.bins[perm]), self.device)
            else:
                # a streamed dataset's matrix lives on the device alone:
                # gather its feature rows there (lightgbm_tpu/models/
                # gbdt.py:290-307), then release the canonical original,
                # which would double the matrix's device memory for the
                # whole run; the dataset is consumed
                log.check(not train_data.device_bins_consumed,
                          "this streamed dataset's device bin matrix was "
                          "consumed by a previous mixed-bin GBDT.init — "
                          "reload the dataset to train another booster "
                          "on it")
                src = train_data.device_bins.to(self.device)
                self.bins_device = src.index_select(
                    0, torch.as_tensor(perm, device=self.device))
                train_data.device_bins = None
                train_data.device_bins_consumed = True
                train_data._device_cache.clear()
        self.num_bins_device = torch.as_tensor(train_data.num_bins,
                                               device=self.device)
        self.early_stopping_round = boosting_config.early_stopping_round
        self.score = torch.as_tensor(
            _start_score(train_data.metadata.init_score, self.num_class,
                         self.num_data), device=self.device)
        if is_int8(self.tree_config.compute_dtype):
            # int32 accumulators: 127 x rows must not wrap (gbdt.py:42-54)
            if self.num_data > (1 << 31) // 127:
                log.fatal("hist_dtype=int8 supports at most %d rows"
                          % ((1 << 31) // 127))
        self._init_sampling(boosting_config)
        objective.init(train_data.metadata, self.num_data, self.device)
        for metric in self.training_metrics:
            metric.init("training", train_data.metadata, self.num_data)
        # "auto" follows the telemetry registry (lightgbm_tpu/models/
        # gbdt.py:437-449)
        self._health_monitor = (health.HealthMonitor(
            on_anomaly=boosting_config.on_anomaly,
            divergence_rounds=boosting_config.health_divergence_rounds,
            quantized=is_int8(self.tree_config.compute_dtype))
            if health.resolve_enabled(boosting_config.health) else None)

    def _init_sampling(self, bc) -> None:
        """The bagging, feature_fraction and GOSS state
        (lightgbm_tpu/models/gbdt.py:333-399)."""
        self._bag_rng = np.random.RandomState(bc.bagging_seed)
        self._use_bagging = bc.bagging_fraction < 1.0 and bc.bagging_freq > 0
        # the growers' row mask: all rows until a bagging draw
        self._bag_mask = torch.ones(self.num_data, dtype=torch.bool,
                                    device=self.device)
        self._bag_device = self._resolve_bagging_device(bc)
        self._bag_draw_idx = 0
        if self._bag_device:
            self._bag_base_key = sampling.bag_key(bc.bagging_seed)
            telemetry.count_route("bagging", "bagging/device")
        elif self._use_bagging:
            telemetry.count_route("bagging", "bagging/host")
        self._feat_mask = (None, None)     # (mask bytes, device mask)
        # per-class feature-fraction streams, one seed
        # (serial_tree_learner.cpp:159-167; one learner per class)
        self._feat_rngs = [
            np.random.RandomState(self.tree_config.feature_fraction_seed)
            for _ in range(self.num_class)]
        self._goss_on = bool(bc.goss)
        if self._goss_on:
            self._goss_key = sampling.bag_key(bc.bagging_seed)
            (self._goss_top_cnt, self._goss_other_cnt,
             self._goss_amp) = sampling.goss_counts(
                self.num_data, bc.top_rate, bc.other_rate)
            log.info("GOSS: keeping top %d rows by |grad| + %d amplified "
                     "(x%.3f) random rows per iteration"
                     % (self._goss_top_cnt, self._goss_other_cnt,
                        self._goss_amp))

    def _resolve_bagging_device(self, bc) -> bool:
        """Where a bagging redraw runs (gbdt.py:549-575): "auto" is the
        threefry draw on the card and the numpy draw on the CPU; "true"
        forces the threefry draw wherever it applies; per-query bagging
        always draws with numpy on the host."""
        if not self._use_bagging or bc.bagging_device == "false":
            return False
        capable = self.train_data.metadata.query_boundaries is None
        if bc.bagging_device == "true":
            if not capable:
                log.warning("bagging_device=true cannot apply here "
                            "(per-query bagging); keeping the host draw")
            return capable
        return capable and self.device.type == "cuda"

    def add_valid_dataset(self, valid_data, valid_metrics,
                          name=None) -> None:
        """GBDT::AddDataset (gbdt.cpp:92-105)."""
        name = name or "valid_%d" % (len(self.valid_datasets) + 1)
        self.valid_datasets.append({
            "bins": valid_data.to_device(self.device)["bins"],
            "score": torch.as_tensor(
                _start_score(valid_data.metadata.init_score, self.num_class,
                             valid_data.num_data), device=self.device),
            "name": name})
        for metric in valid_metrics:
            metric.init(name, valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(list(valid_metrics))
        self.best_score.append([-1.0] * len(valid_metrics))
        self.best_iter.append([0] * len(valid_metrics))

    # ------------------------------------------------------------- iteration

    def train_one_iter(self, is_eval: bool = True) -> bool:
        """GBDT::TrainOneIter (gbdt.cpp:167-214), as
        lightgbm_tpu/models/gbdt.py:1171-1319 runs it: the gradients of
        every class once (and the GOSS draw over them), then one tree per
        class in order, each after its own bagging draw and feature
        sample, each updating its class's training and validation scores.
        True when training must stop: the first class whose tree has a
        single leaf ends the iteration, and the trees of the classes
        before it stay; or early stopping, which drops the last
        ``early_stopping_round`` iterations' trees.  Each phase runs
        under its telemetry span, and with a sink one record is written
        an iteration (module docstring)."""
        self._file_residency()
        mon = self._health_monitor
        with telemetry.span("gradient") as sp:
            grad, hess = self.objective.get_gradients(
                self.score if self.num_class > 1 else self.score[0])
            sp.fence((grad, hess))
        if self.num_class == 1:
            grad, hess = grad[None], hess[None]
        g_grow, h_grow, goss_mask = self._goss_masks(grad, hess)
        hvec = None
        for cls in range(self.num_class):
            with telemetry.span("bagging"):
                self._draw_bag_mask(self.iter)
            row_mask = goss_mask if goss_mask is not None else self._bag_mask
            with telemetry.span("grow") as sp:
                tree_arrays = self._grow(g_grow[cls], h_grow[cls], row_mask,
                                         self._feature_sample(cls))
                sp.fence(tree_arrays.leaf_ids)
            n = tree_arrays.num_leaves
            if mon is not None:
                mon.add_tree(n, tree_arrays.split_gain, tree_arrays.leaf_count)
            if n <= 1:
                log.info("Can't training anymore, there isn't any leaf "
                         "meets split requirements.")
                if mon is not None:
                    # the gradients may be why no split was found: record
                    # the block and apply the policy before stopping
                    with telemetry.span("model_readback"):
                        hvec = mon.vector(grad, hess, self.score).cpu()
                    block = mon.assemble(hvec.numpy())
                    if telemetry.sink_active():
                        dp, dt = telemetry.take_phase_deltas()
                        telemetry.emit_iteration(
                            self.iter + 1, dp, dt,
                            eval_metrics=self._last_eval_values,
                            health=block,
                            memory=telemetry.take_memory_record(),
                            extra={"stopped": "degenerate_tree"})
                    mon.apply_policy(block, self.iter + 1)
                return True
            # shrinkage in f32 on the device, as the JAX package does
            lr = torch.tensor(self.gbdt_config.learning_rate,
                              dtype=torch.float32, device=self.device)
            with telemetry.span("score_update") as sp:
                shrunk = torch.as_tensor(tree_arrays.leaf_value,
                                         device=self.device) * lr
                self.score[cls] = train_score_update(self.score[cls], shrunk,
                                                     tree_arrays.leaf_ids)
                sp.fence(self.score)
            if self.valid_datasets:
                with telemetry.span("valid_update") as sp:
                    for entry in self.valid_datasets:
                        entry["score"][cls] = add_tree_score(
                            entry["bins"], entry["score"][cls],
                            tree_arrays.split_feature[:n - 1],
                            tree_arrays.threshold_bin[:n - 1],
                            tree_arrays.left_child[:n - 1],
                            tree_arrays.right_child[:n - 1], shrunk)
                        sp.fence(entry["score"])
            with telemetry.span("model_readback"):
                tree = self._to_host_tree(tree_arrays)
                if mon is not None and cls == self.num_class - 1:
                    # the health vector's one host read, over the raw
                    # gradients and the updated scores
                    hvec = mon.vector(grad, hess, self.score).cpu()
            tree.shrinkage(self.gbdt_config.learning_rate)
            self.models.append(tree)
        met_early_stopping = False
        if is_eval:
            with telemetry.span("eval"):
                met_early_stopping = self.output_metric(self.iter + 1)
        self.iter += 1
        block = mon.assemble(hvec.numpy()) if mon is not None else None
        if telemetry.sink_active():
            dp, dt = telemetry.take_phase_deltas()
            telemetry.emit_iteration(self.iter, dp, dt,
                                     eval_metrics=self._last_eval_values,
                                     health=block,
                                     memory=telemetry.take_memory_record())
        if mon is not None:
            # after the record: a halt must not lose the record that
            # explains it
            mon.apply_policy(block, self.iter)
        if met_early_stopping:
            log.info("Early stopping at iteration %d, the best iteration "
                     "round is %d"
                     % (self.iter, self.iter - self.early_stopping_round))
            # pop back the last early_stopping_round iterations' trees
            # (gbdt.cpp:205-210)
            del self.models[len(self.models)
                            - self.early_stopping_round * self.num_class:]
        return met_early_stopping

    def _file_residency(self) -> None:
        """The one-shot dataset-residency report of the memory gauges,
        at the first iteration (lightgbm_tpu/models/gbdt.py:464-502)."""
        if self._residency_filed or not telemetry.memory_enabled():
            return
        self._residency_filed = True
        telemetry.set_residency(self._residency_report())

    def _residency_report(self) -> dict:
        """Static device footprint of the training state: the bin matrix,
        the scores, the metadata, the histogram scratch of the grower."""
        F, B = self.train_data.num_features, self.num_bins_max
        L = self._num_leaves()
        md = self.train_data.metadata
        md_bytes = sum(int(np.asarray(a).nbytes) for a in
                       (md.label, md.weights, md.init_score,
                        md.query_boundaries) if a is not None)
        if self.tree_config.policy == "depthwise":
            # the widest level: P parent slots, each [F, B, 3] f32, live
            # twice across the subtraction
            from .grower_depthwise import num_levels
            P = 1 << max(num_levels(L, self.tree_config.max_depth) - 1, 0)
            hist_scratch = 2 * P * F * B * 3 * 4
        else:
            hist_scratch = L * F * B * 3 * 4     # the [L, F, B, 3] cache

        def nbytes(t):
            return int(t.numel() * t.element_size())

        return {
            "num_rows": int(self.num_data),
            "num_features": int(F),
            "num_bins_max": int(B),
            "bin_matrix_bytes": nbytes(self.bins_device),
            "score_bytes": nbytes(self.score),
            "metadata_bytes": int(md_bytes),
            "hist_scratch_bytes": int(hist_scratch),
            "valid_bins_bytes": sum(nbytes(e["bins"])
                                    for e in self.valid_datasets),
        }

    def health_summary(self):
        """Cumulative health totals (None when the monitor is off)."""
        return (self._health_monitor.summary()
                if self._health_monitor is not None else None)

    # -------------------------------------------------------------- sampling

    def _draw_bag_mask(self, it: int) -> None:
        """GBDT::Bagging (gbdt.cpp:106-157), once per (iteration, class)
        as gbdt.py:576-628: on a redraw iteration each class tree gets a
        fresh draw.  The threefry draw keys the draw count; the numpy
        draw takes ``int(frac·n)`` records (or ``int(frac·nq)`` whole
        queries) without replacement from one stream, then uploads."""
        if not self._use_bagging or it % self.gbdt_config.bagging_freq != 0:
            return
        if tracing.active():
            tracing.event("bagging_draw", iter=int(it))
        frac = self.gbdt_config.bagging_fraction
        n = self.num_data
        if self._bag_device:
            bag_cnt = int(frac * n)
            self._bag_mask = sampling.bag_mask_for_draw(
                self._bag_base_key, self._bag_draw_idx, n, bag_cnt,
                self.device)
            self._bag_draw_idx += 1
            log.info("re-bagging, using %d data to train" % bag_cnt)
            return
        qb = self.train_data.metadata.query_boundaries
        mask = np.zeros(n, dtype=bool)
        if qb is None:
            bag_cnt = int(frac * n)
            mask[self._bag_rng.choice(n, bag_cnt, replace=False)] = True
        else:
            nq = qb.size - 1
            for q in self._bag_rng.choice(nq, int(nq * frac),
                                          replace=False):
                mask[qb[q]:qb[q + 1]] = True
            bag_cnt = int(mask.sum())
        log.info("re-bagging, using %d data to train" % bag_cnt)
        self._bag_mask = torch.from_numpy(mask).to(self.device)

    def _goss_masks(self, grad, hess):
        """The GOSS draw of this iteration over all classes' [K, N]
        gradients, keyed ``fold_in(PRNGKey(bagging_seed), iter)``
        (gbdt.py:640-670): (amplified grad, amplified hess, row mask), or
        the inputs and None when GOSS is off."""
        if not self._goss_on:
            return grad, hess, None
        with telemetry.span("goss") as sp:
            out = sampling.goss_select(
                threefry.fold_in(self._goss_key, self.iter), grad, hess,
                self._goss_top_cnt, self._goss_other_cnt, self._goss_amp)
            sp.fence(out[2])
        telemetry.count("goss/iterations")
        if tracing.active():
            tracing.event("goss_draw", iter=int(self.iter))
        return out

    def _feature_sample(self, cls: int) -> torch.Tensor:
        """[F] bool on the device: ``max(int(F·frac), 1)`` features from
        class ``cls``'s stream (gbdt.py:672-680), or all of them."""
        frac = self.tree_config.feature_fraction
        F = self.train_data.num_features
        mask = np.ones(F, dtype=bool)
        if frac < 1.0:
            mask[:] = False
            mask[self._feat_rngs[cls].choice(F, max(int(F * frac), 1),
                                             replace=False)] = True
        # the classes' streams move in lockstep, so one upload serves every
        # class of an iteration
        if self._feat_mask[0] != mask.tobytes():
            self._feat_mask = (mask.tobytes(),
                               torch.from_numpy(mask).to(self.device))
        return self._feat_mask[1]

    def _num_leaves(self) -> int:
        """The leaf budget of a tree (config.h:159-163)."""
        tc = self.tree_config
        num_leaves = tc.num_leaves
        if tc.max_depth > 0:
            num_leaves = min(num_leaves, 1 << (tc.max_depth - 1))
        return max(num_leaves, 2)

    def _grow(self, grad, hess, row_mask, feature_mask):
        """One tree over the rows' [N] gradients, under the configured
        growth policy."""
        tc = self.tree_config
        return grow_tree_unified(
            self.bins_device, grad, hess, row_mask, feature_mask,
            self.num_bins_device, policy=tc.policy,
            num_leaves=self._num_leaves(),
            num_bins_max=self.num_bins_max,
            min_data_in_leaf=tc.min_data_in_leaf,
            min_sum_hessian_in_leaf=tc.min_sum_hessian_in_leaf,
            max_depth=tc.max_depth, compute_dtype=tc.compute_dtype,
            packing=self._pack_spec)

    def run_training(self, num_iterations: int, is_eval: bool,
                     save_fn: Optional[Callable] = None,
                     progress_fn: Optional[Callable] = None) -> None:
        """The per-iteration loop of Application::Train
        (application.cpp:239-257), with the JAX package's boundary work
        (lightgbm_tpu/models/gbdt.py:1520-1720): every
        ``checkpoint_interval`` iterations a snapshot goes to a background
        writer, the fault hatch fires at each boundary, one checkpoint is
        written synchronously at the end and one, best effort, on an
        exception; the writer is always closed.  With ``stall_timeout``
        configured the telemetry watchdog runs around the loop.  With a
        sink, the summary record closes the run; an exception escaping
        the loop writes it marked ``aborted`` and then dumps the flight
        recorder's ring before re-raising."""
        bc = self.gbdt_config
        wd_armed = telemetry.arm_watchdog()
        if wd_armed:
            telemetry.watchdog_checkin(phase="run_training",
                                       iteration=self.iter)
        writer = None
        if bc.checkpoint_interval > 0:
            log.check(bool(bc.checkpoint_dir),
                      "checkpoint_interval > 0 requires checkpoint_dir")
            writer = checkpoint.CheckpointWriter(bc.checkpoint_dir,
                                                 keep=bc.checkpoint_keep)
            self.checkpoint_writer = writer
        last_ckpt = self.iter
        try:
            for _ in range(num_iterations):
                finished = self.train_one_iter(is_eval=is_eval)
                if wd_armed:
                    telemetry.watchdog_checkin(iteration=self.iter)
                if save_fn is not None:
                    save_fn()
                if progress_fn is not None:
                    progress_fn(self.iter)
                if finished:
                    break
                if writer is not None \
                        and self.iter - last_ckpt >= bc.checkpoint_interval:
                    writer.submit(self.checkpoint_state())
                    last_ckpt = self.iter
                faults.maybe_fire(self.iter)
            if writer is not None:
                # a restart after a clean finish sees the complete run
                writer.write_sync(self.checkpoint_state())
        except BaseException as e:
            if writer is not None:
                # an exception between iterations leaves the state whole;
                # if it is torn, the write fails and the last periodic
                # checkpoint stands
                try:
                    writer.write_sync(self.checkpoint_state())
                except Exception as err:
                    log.warning("final checkpoint not written: %s" % err)
            if telemetry.sink_active():
                extra = {"aborted": type(e).__name__, "iterations": self.iter}
                if self._health_monitor is not None:
                    extra["health"] = self._health_monitor.summary()
                try:
                    telemetry.emit_summary(extra=extra)
                except Exception as err:  # the real fault is re-raised
                    log.warning("aborted run's summary not written: %s"
                                % err)
            tracing.dump_on_fault(type(e).__name__)
            raise
        finally:
            if writer is not None:
                writer.close()
            if wd_armed:
                telemetry.disarm_watchdog()
        if telemetry.sink_active():
            extra = {"iterations": self.iter}
            if self._health_monitor is not None:
                extra["health"] = self._health_monitor.summary()
            telemetry.emit_summary(extra=extra)

    # ------------------------------------------------------- checkpoints

    def checkpoint_fingerprint(self) -> dict:
        """The config fields a restored run must match exactly, the JAX
        package's (lightgbm_tpu/models/gbdt.py:771-808): a checkpoint of
        either package is compared field by field, and a mismatch names
        the field."""
        bc, tc = self.gbdt_config, self.tree_config
        return {
            "objective": (type(self.objective).__name__
                          if self.objective is not None else None),
            "num_class": int(self.num_class),
            "learning_rate": float(bc.learning_rate),
            "bagging_fraction": float(bc.bagging_fraction),
            "bagging_freq": int(bc.bagging_freq),
            "bagging_seed": int(bc.bagging_seed),
            # the resolved stream, not the key: "auto" resolving to the
            # other stream on restore would fork the draws
            "bagging_stream": ("device" if self._bag_device
                               else "host" if self._use_bagging else "off"),
            "feature_fraction": float(tc.feature_fraction),
            "feature_fraction_seed": int(tc.feature_fraction_seed),
            "goss": bool(bc.goss),
            "top_rate": float(bc.top_rate),
            "other_rate": float(bc.other_rate),
            "num_leaves": int(tc.num_leaves),
            "max_depth": int(tc.max_depth),
            "min_data_in_leaf": int(tc.min_data_in_leaf),
            "min_sum_hessian_in_leaf": float(tc.min_sum_hessian_in_leaf),
            "grow_policy": str(tc.grow_policy),
            "hist_dtype": str(tc.hist_dtype),
            "quant_rounding": str(tc.quant_rounding),
            "early_stopping_round": int(bc.early_stopping_round),
        }

    def _dataset_fingerprint(self) -> dict:
        """The dataset's identity: rows, feature counts, validation sets."""
        return {
            "num_features": int(self.train_data.num_features),
            "num_total_features": int(self.train_data.num_total_features),
            "num_rows": int(self.train_data.num_data),
            "num_valid": len(self.valid_datasets),
        }

    @staticmethod
    def _topology_info() -> dict:
        """One process, the serial learner."""
        return {"tree_learner": "serial", "num_machines": 1,
                "process_count": 1}

    def _rng_snapshot(self):
        """(bagging stream, per-class feature_fraction streams); a part
        whose sampling is off is None."""
        ff = ([r.get_state() for r in self._feat_rngs]
              if self.tree_config.feature_fraction < 1.0 else None)
        return self._bag_snapshot(), ff

    def _bag_snapshot(self):
        """The bagging stream's state: the threefry draw counter, or the
        host MT19937 state and a host copy of the current mask."""
        if not self._use_bagging:
            return None
        if self._bag_device:
            return ("device", self._bag_draw_idx)
        return ("host", self._bag_rng.get_state(),
                self._bag_mask.to("cpu", copy=True).numpy())

    def checkpoint_state(self) -> dict:
        """A consistent raw snapshot at the iteration boundary
        (checkpoint.serialize_state turns it into the payload, on the
        writer thread).  The scores are copied to the host here, on the
        training thread: the boosting loop updates them in place, and a
        copy taken here is ordered after every queued update."""
        return {
            "iteration": int(self.iter),
            "num_class": int(self.num_class),
            "models": tuple(self.models),
            "best_score": [list(r) for r in self.best_score],
            "best_iter": [list(r) for r in self.best_iter],
            "rng": self._rng_snapshot(),
            "score": self.score.to("cpu", copy=True).numpy(),
            "valid_scores": [e["score"].to("cpu", copy=True).numpy()
                             for e in self.valid_datasets],
            "config": self.checkpoint_fingerprint(),
            "dataset": self._dataset_fingerprint(),
            "topology": self._topology_info(),
        }

    def restore_checkpoint(self, payload) -> None:
        """Continue training from a checkpoint payload (a loaded dict, or
        a path), on a fresh booster after ``init`` and
        ``add_valid_dataset`` (lightgbm_tpu/models/gbdt.py:875-960): the
        fingerprints are compared field by field, then the trees, sampler
        streams, early-stopping state and raw f32 scores are restored
        exactly, so the continuation is the unbroken run's bit for bit.
        The incremental model file starts over, so a resumed CLI run
        writes the whole model again."""
        try:
            if isinstance(payload, str):
                payload = checkpoint.load_checkpoint(payload)
            log.check(self.train_data is not None,
                      "restore_checkpoint requires init() first")
            if self.models or self.iter:
                log.fatal("restore_checkpoint requires a freshly "
                          "initialized booster (input_model continuation "
                          "and checkpoint resume are mutually exclusive)")
            checkpoint.check_fingerprint(payload,
                                         self.checkpoint_fingerprint(),
                                         self._dataset_fingerprint())
        except checkpoint.CheckpointError as e:
            log.fatal(str(e))
        models = [checkpoint.tree_from_json(t) for t in payload["trees"]]
        rng = payload["rng"]
        ff = rng["feature_fraction"]
        if ff is not None and len(ff) != len(self._feat_rngs):
            log.fatal("checkpoint rng field 'feature_fraction' has %d "
                      "streams, this run has %d classes"
                      % (len(ff), len(self._feat_rngs)))
        stored = checkpoint.array_from_json(payload["score"])
        if tuple(stored.shape) != (self.num_class, self.num_data):
            log.fatal("checkpoint field 'score' has shape %s, this run "
                      "needs (%d, %d)" % (tuple(stored.shape),
                                          self.num_class, self.num_data))
        vs = payload["valid_scores"]
        if len(vs) != len(self.valid_datasets):
            log.fatal("checkpoint field 'valid_scores' has %d sets, this "
                      "run configured %d validation dataset(s)"
                      % (len(vs), len(self.valid_datasets)))
        self._restore_bag_json(rng["bagging"])
        if ff is not None:
            for r, state in zip(self._feat_rngs, ff):
                r.set_state(checkpoint.rng_state_from_json(state))
        self.models = models
        telemetry.count("ckpt/restored")
        self.iter = int(payload["iteration"])
        self.best_score = [list(map(float, r))
                           for r in payload["best_score"]]
        self.best_iter = [list(map(int, r)) for r in payload["best_iter"]]
        self.score = torch.as_tensor(stored, device=self.device)
        for entry, sj in zip(self.valid_datasets, vs):
            entry["score"] = torch.as_tensor(checkpoint.array_from_json(sj),
                                             device=self.device)
        if self._model_file is not None and not self._model_file.closed:
            self._model_file.close()
        self._saved_model_size = -1
        self._model_file = None
        log.info("restored checkpoint at iteration %d (%d trees)"
                 % (self.iter, len(self.models)))

    def _restore_bag_json(self, obj) -> None:
        """The bagging stream from its checkpoint form (the stream's mode
        already matched through the fingerprint): the threefry draw
        counter, with the current mask redrawn from it, or the host
        MT19937 state and mask."""
        if obj is None:
            return
        n = self.num_data
        if obj["mode"] == "device":
            self._bag_draw_idx = int(obj["draw_idx"])
            if self._bag_draw_idx > 0:
                self._bag_mask = sampling.bag_mask_for_draw(
                    self._bag_base_key, self._bag_draw_idx - 1, n,
                    int(self.gbdt_config.bagging_fraction * n), self.device)
            return
        mask = checkpoint.mask_from_json(obj["mask"])
        if mask.size != n:
            log.fatal("checkpoint rng field 'bagging' mask covers %d rows, "
                      "this run has %d" % (mask.size, n))
        self._bag_rng.set_state(checkpoint.rng_state_from_json(obj["state"]))
        self._bag_mask = torch.from_numpy(mask).to(self.device)

    def resume_latest(self, directory: str) -> None:
        """Restore the latest checkpoint in ``directory``, if it holds one
        (lightgbm_tpu/cli.py:368-378)."""
        latest = checkpoint.latest_checkpoint(directory) if directory \
            else None
        if latest is None:
            return
        log.info("resuming from checkpoint %s" % latest)
        self.restore_checkpoint(latest)

    def remaining_iterations(self, num_iterations: int) -> int:
        """Iterations left of a run's total budget after a restore
        (lightgbm_tpu/cli.py:482-491): a restart after a clean finish
        trains none and rewrites the final model."""
        remaining = max(num_iterations - self.iter, 0)
        if remaining < num_iterations:
            log.info("checkpoint restore banked %d iteration(s); training "
                     "%d more" % (self.iter, remaining))
        return remaining

    def _to_host_tree(self, t) -> Tree:
        n = t.num_leaves
        sf = t.split_feature[:n - 1]
        tb = t.threshold_bin[:n - 1]
        return Tree(
            num_leaves=n, split_feature=sf,
            split_feature_real=self.train_data.real_feature_idx[sf],
            threshold_bin=tb, threshold=self._bin_upper_table[sf, tb],
            split_gain=np.asarray(t.split_gain, np.float64)[:n - 1],
            left_child=t.left_child[:n - 1],
            right_child=t.right_child[:n - 1],
            leaf_parent=t.leaf_parent[:n],
            leaf_value=np.asarray(t.leaf_value, np.float64)[:n],
            leaf_count=t.leaf_count[:n])

    # --------------------------------------------------------------- metrics

    def eval_values(self, train: bool = True, valid: bool = True):
        """(train values, [valid values per dataset]) of the metrics, over
        the [N] score, or the [K·N] class-major one when K > 1
        (lightgbm_tpu/models/gbdt.py:2376-2385); a side not asked for is
        None."""
        def flat(score):
            score = score.cpu().numpy()
            return score.reshape(-1) if self.num_class > 1 else score[0]

        train_vals = valid_vals = None
        if train:
            train_vals = [m.eval(flat(self.score))
                          for m in self.training_metrics]
        if valid:
            valid_vals = [[m.eval(flat(e["score"])) for m in metrics]
                          for e, metrics in zip(self.valid_datasets,
                                                self.valid_metrics)]
        return train_vals, valid_vals

    def output_metric(self, iteration: int) -> bool:
        """GBDT::OutputMetric (gbdt.cpp:225-259), as gbdt.py:2369-2456:
        training metrics print every ``metric_freq`` iterations; the
        validation metrics are also evaluated every iteration while
        early stopping is on, and keep each (set, metric)'s best value
        and iteration.  True when one of them has not improved for
        ``early_stopping_round`` iterations."""
        freq = self.gbdt_config.output_freq
        eval_now = freq > 0 and iteration % freq == 0
        train, valid = self.eval_values(
            train=eval_now, valid=eval_now or self.early_stopping_round > 0)
        self._observe_metric_values(train, valid)
        if eval_now:
            for metric, values in zip(self.training_metrics, train):
                log.info("Iteration:%d, %s : %s" % (
                    iteration, metric.name,
                    " ".join(str(v) for v in values)))
        ret = False
        for i, values_i in enumerate(valid or []):
            for j, (metric, values) in enumerate(zip(self.valid_metrics[i],
                                                     values_i)):
                if eval_now:
                    log.info("Iteration:%d, %s : %s" % (
                        iteration, metric.name,
                        " ".join(str(v) for v in values)))
                if ret or self.early_stopping_round <= 0:
                    continue
                last = values[-1]
                best = self.best_score[i][j]
                if (best < 0 or (not metric.is_bigger_better and last < best)
                        or (metric.is_bigger_better and last > best)):
                    self.best_score[i][j] = last
                    self.best_iter[i][j] = iteration
                elif (iteration - self.best_iter[i][j]
                        >= self.early_stopping_round):
                    ret = True
        return ret

    def _observe_metric_values(self, train, valid) -> None:
        """The record's ``eval_metrics`` (``<set>/<metric>`` -> values)
        and the health monitor's divergence tracking
        (lightgbm_tpu/models/gbdt.py:2402-2432)."""
        named = []
        if train is not None:
            named += [("training/" + m.name, m, v)
                      for m, v in zip(self.training_metrics, train)]
        for e, metrics, values in zip(self.valid_datasets,
                                      self.valid_metrics, valid or []):
            named += [(e["name"] + "/" + m.name, m, v)
                      for m, v in zip(metrics, values)]
        if telemetry.sink_active() and named:
            self._last_eval_values = {k: [float(x) for x in v]
                                      for k, _, v in named}
        if self._health_monitor is not None:
            for key, metric, values in named:
                self._health_monitor.observe_eval(
                    key, float(values[-1]), metric.is_bigger_better)

    # ------------------------------------------------------------ prediction

    def predict_raw(self, features: np.ndarray,
                    num_used_model: int = -1) -> np.ndarray:
        """Batch PredictRaw (gbdt.cpp:470-479): raw scores from raw feature
        values, walked in float64 in torch on this booster's device; [N],
        or [K, N] when K > 1.  ``num_used_model`` counts iterations (K
        trees each); negative means all."""
        device = self.device if self.device is not None \
            else resolve_device(None)
        out = predict_raw_scores(self._used_models(num_used_model), features,
                                 device, self.num_class)
        return out[0] if self.num_class == 1 else out

    def _used_models(self, num_used_model: int) -> List[Tree]:
        if num_used_model < 0:
            return self.models
        return self.models[:num_used_model * self.num_class]

    def predict(self, features: np.ndarray,
                num_used_model: int = -1) -> np.ndarray:
        """Predict with the sigmoid transform (gbdt.cpp:481-494)."""
        ret = self.predict_raw(features, num_used_model)
        if self.sigmoid > 0:
            ret = 1.0 / (1.0 + np.exp(-2.0 * self.sigmoid * ret))
        return ret

    def predict_multiclass(self, features: np.ndarray,
                           num_used_model: int = -1) -> np.ndarray:
        """[N, K] softmax probabilities (gbdt.cpp:496-508)."""
        out = self.predict_raw(features, num_used_model)
        return softmax_rows(out.reshape(self.num_class, -1).T)

    def export_flat(self, num_models: int = -1) -> FlatEnsemble:
        """The first ``num_models`` trees (all when < 0) flattened for
        the serving engine (lightgbm_tpu/models/gbdt.py:2494-2505)."""
        models = self.models if num_models < 0 else self.models[:num_models]
        flat = FlatEnsemble.from_models(models, self.num_class)
        # the drift baseline rides the flattened ensemble, so a front can
        # register it without the booster
        flat.score_reference = self.capture_score_reference()
        return flat

    def capture_score_reference(self) -> Optional[dict]:
        """The live training scores as a monitor.ScoreHistogram dict, the
        drift baseline (lightgbm_tpu/models/gbdt.py:2464-2492): recaptured
        from the current scores on every call while the booster holds
        them (the true rows' [K, N] scores as float64 on the host); a
        booster without scores (a loaded model) keeps the reference its
        file carried, or None."""
        score = getattr(self, "score", None)
        if score is None:
            return self.score_reference
        from ..monitor import ScoreHistogram
        values = score.detach().to("cpu").numpy().astype(np.float64)
        n = int(getattr(self, "num_data", 0)) or values.shape[-1]
        values = values[..., :n].ravel()
        if values.size == 0:
            return None
        hist = ScoreHistogram()
        hist.record_many(values)
        self.score_reference = hist.to_dict()
        return self.score_reference

    def _score_reference_line(self) -> str:
        """``score_reference=<json>\\n``, or "" without a reference."""
        reference = self.capture_score_reference()
        if reference is None:
            return ""
        return "score_reference=%s\n" % json.dumps(reference,
                                                    separators=(",", ":"))

    def serving_engine(self, num_models: int = -1,
                       **options) -> ServingEngine:
        """The cached serving engine over the first ``num_models`` trees,
        on this booster's device (lightgbm_tpu/models/gbdt.py:2507-2522).
        The cache key holds the model count, so more trees (continued
        training) flatten anew."""
        if num_models < 0:
            num_models = len(self.models)
        key = (len(self.models), num_models, tuple(sorted(options.items())))
        if self._serve_cache is not None and self._serve_cache[0] == key:
            return self._serve_cache[1]
        device = self.device if self.device is not None \
            else resolve_device(None)
        engine = ServingEngine(self.export_flat(num_models), device=device,
                               **options)
        self._serve_cache = (key, engine)
        return engine

    def predict_leaf_index(self, features: np.ndarray,
                           num_used_model: int = -1) -> np.ndarray:
        """[N, num_models] int32 leaf indices (gbdt.cpp:510-519);
        ``num_used_model`` counts trees, as the JAX package's does.  The
        ids are exact integers, so the engine answers at every size what
        the JAX package's host replay answers below its device
        threshold."""
        if num_used_model < 0:
            num_used_model = len(self.models)
        return self.serving_engine(
            len(self.models[:num_used_model])).leaf_indices(features)

    # -------------------------------------------------------------- model IO

    def save_model_to_file(self, is_finish: bool, filename: str) -> None:
        """Incremental text save (gbdt.cpp:307-348), in the JAX package's
        format (lightgbm_tpu/models/gbdt.py:2605-2642): each call appends
        the finished trees but the last ``early_stopping_round``
        iterations', which early stopping may still drop; the final call
        writes the rest, then the ``score_reference=`` line (at finish,
        so an early save cannot freeze an early-iteration distribution
        into the model) and the feature importances."""
        if self._saved_model_size == -1:
            self._model_file = open(filename, "w")
            self._model_file.write(self.model_header())
            self._saved_model_size = 0
        if self._model_file is None or self._model_file.closed:
            return
        rest = len(self.models) - self.early_stopping_round * self.num_class
        if is_finish:
            rest = len(self.models)
        for i in range(self._saved_model_size, rest):
            self._model_file.write("Tree=%d\n" % i)
            self._model_file.write(self.models[i].to_string() + "\n")
        self._saved_model_size = max(self._saved_model_size, rest)
        self._model_file.flush()
        if is_finish:
            self._model_file.write(self._score_reference_line())
            self._model_file.write("\n" + self.feature_importance() + "\n")
            self._model_file.close()

    def model_header(self) -> str:
        return ("gbdt\nnum_class=%d\nlabel_index=%d\nmax_feature_idx=%d\n"
                "sigmoid=%s\n\n" % (self.num_class, self.label_idx,
                                     self.max_feature_idx,
                                     repr(float(self.sigmoid))))

    def model_to_string(self) -> str:
        """The whole model file's text, as save_model_to_file writes it."""
        return (self.model_header()
                + "".join("Tree=%d\n%s\n" % (i, t.to_string())
                          for i, t in enumerate(self.models))
                + self._score_reference_line()
                + "\n" + self.feature_importance() + "\n")

    def models_from_string(self, model_str: str) -> None:
        """GBDT::ModelsFromString (gbdt.cpp:350-441)."""
        self.models = []
        lines = model_str.split("\n")

        def find_value(key):
            for line in lines:
                if key in line and "=" in line:
                    return line.split("=", 1)[1].strip()
            return None

        for key in ("num_class=", "label_index=", "max_feature_idx="):
            if find_value(key) is None:
                log.fatal("Model file doesn't contain %s" % key[:-1])
        self.num_class = int(find_value("num_class="))
        self.label_idx = int(find_value("label_index="))
        self.max_feature_idx = int(find_value("max_feature_idx="))
        sigmoid = find_value("sigmoid=")
        self.sigmoid = float(sigmoid) if sigmoid is not None else -1.0
        reference = find_value("score_reference=")
        if reference is not None:
            try:
                self.score_reference = json.loads(reference)
            except ValueError:
                self.score_reference = None
        i = 0
        while i < len(lines):
            if "Tree=" in lines[i]:
                i += 1
                start = i
                while i < len(lines) and "Tree=" not in lines[i]:
                    i += 1
                self.models.append(Tree.from_string(
                    "\n".join(lines[start:i])))
            else:
                i += 1
        log.info("%d models has been loaded" % len(self.models))

    @classmethod
    def from_model_file(cls, filename: str, device=None) -> "GBDT":
        """Boosting::CreateBoosting from file (boosting.cpp:6-57)."""
        if not os.path.exists(filename):
            log.fatal("Model file %s doesn't exist" % filename)
        with open(filename, "r") as f:
            content = f.read()
        first_line = content.split("\n", 1)[0].strip()
        if first_line != "gbdt":
            log.fatal("Unknown boosting type %s" % first_line)
        self = cls()
        self.device = resolve_device(device)
        self.models_from_string(content)
        return self

    def feature_importance(self) -> str:
        """Split-count importances (gbdt.cpp:443-468)."""
        importances = np.zeros(self.max_feature_idx + 1, dtype=np.int64)
        for tree in self.models:
            for f in tree.split_feature_real:
                importances[f] += 1
        names = (self.train_data.feature_names
                 if self.train_data is not None
                 else ["Column_%d" % i
                       for i in range(self.max_feature_idx + 1)])
        pairs = sorted(zip(importances, names), key=lambda p: -p[0])
        out = ["", "feature importances:"]
        out += ["%s=%d" % (name, cnt) for cnt, name in pairs]
        return "\n".join(out) + "\n"


def _start_score(init_score, num_class: int, num_data: int) -> np.ndarray:
    """[K, N] f32 starting score: the rows' initial scores tiled over the
    K classes (gbdt.py:319-322, 534-537), else zeros."""
    if init_score is None:
        return np.zeros((num_class, num_data), np.float32)
    return np.tile(np.asarray(init_score, np.float32), (num_class, 1))
