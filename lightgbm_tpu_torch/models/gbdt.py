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
Checkpoints (:701-1139, the non-pipelined branches):
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
booster.  None of it moves a tree.  The fused chunk programs and the
deferred-readback pipeline are not ported; their telemetry goes with
them.

Under a parallel learner (``init(..., learner=)``, parallel/learners.py)
the booster is one rank's: N is the rank's own row count (its shard
under ``tree_learner=data``, its data index's under ``hybrid`` and
``voting``, every row under ``feature``), every rank grows the same
trees through the learner, and each rank bags its own rows with the host
draw from ``bagging_seed`` (so a grid's feature group bags alike).
The world's rows go by serial row order (``SerialRows``: each rank's
rows at their ``used_data_indices``, each data shard once), the rule
the JAX package's single process keeps and its multi-process layout
breaks (ROADMAP C9, C10).  Training metrics and the ``score_reference=``
line read the scores and the metadata gathered in it, so they are the
serial run's, and so is the health block (health.py, 3); the int8 row
bound is checked on the world's N; lambdarank needs query-atomic
shards.  The GOSS draw runs over the
world's row scores gathered in that order, so a world's GOSS trees are
the serial run's, and a checkpoint stores the scores in it, so a
world's checkpoint is a serial one and a restore fits any number of
ranks.  Rank 0 writes the checkpoints; a rank with its own host bagging
state writes its own beside them.  The straggler drain
(``enable_elastic``, elastic.py) compares the ranks' own work between
boundaries, checkpoints the world, agrees on the survivors and stops
every rank for their restart.

The score is a [K, N] f32 tensor on the training device (K = num_class,
1 unless the objective is multiclass); gradients, histograms, partitions
and score updates run there, and the host holds the trees and the
metrics.  Each iteration grows K trees, ``models[iter * K + k]`` for
class k, as gbdt.cpp:175-195.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import checkpoint, elastic, faults, health, telemetry, tracing
from ..device import resolve_device
from ..objectives.rank import LambdarankNDCG
from ..ops import sampling
from ..ops.bins import to_tensor as bins_to_tensor
from ..ops.histogram import is_int8
from ..ops.scoring import add_tree_score, train_score_update
from ..parallel import learners, mesh
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
        # a parallel learner (parallel/learners.py) and whether this
        # booster's rows are one shard of a world of more than one rank
        self._learner = None
        self._sharded = False
        # a sharded world's rows in serial row order (SerialRows)
        self._rows = None
        # the straggler drain's monitor (enable_elastic), or None, and
        # the clock and the wait clock of the last iteration boundary
        self._straggler = None
        self._boundary_t = self._boundary_wait = 0.0

    # ------------------------------------------------------------------ init

    def init(self, boosting_config, train_data, objective,
             training_metrics=(), device=None, learner=None) -> None:
        """GBDT::Init (gbdt.cpp:41-89).  ``device``: "cuda" (default; a
        Fatal when there is no card) or "cpu".  ``learner``: a parallel
        learner (module docstring); it binds this rank's device and
        collective group, so every rank of its world calls ``init``."""
        self.device = resolve_device(device)
        self._learner = learner
        if learner is not None:
            self.device = learner.bind(self.device)
            # a grid's rows are sharded over its data shards alone
            self._sharded = learner.shards_rows and getattr(
                learner, "data_shards", learner.world) > 1
            self._check_world(boosting_config, train_data, objective)
            if self._sharded:
                self._rows = SerialRows(learner.comm, train_data,
                                        self._row_step(), self.device)
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
        self._pack_spec = self._plan_packing(train_data, learner)
        if self._pack_spec is None:
            self.bins_device = train_data.to_device(self.device)["bins"]
        else:
            perm = np.asarray(self._pack_spec.perm, np.int64)
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
            # int32 accumulators: 127 x rows must not wrap (gbdt.py:42-54);
            # a world's sums are the world's rows
            if self.global_num_data() > (1 << 31) // 127:
                log.fatal("hist_dtype=int8 supports at most %d rows"
                          % ((1 << 31) // 127))
        self._init_sampling(boosting_config)
        objective.init(train_data.metadata, self.num_data, self.device)
        if self._sharded and self.training_metrics:
            # the world's rows in serial row order: the serial run's
            # values (lightgbm_tpu/models/gbdt.py:425-432 gathers them in
            # process order)
            md = train_data.metadata.global_view(self._rows.gather_host)
            for metric in self.training_metrics:
                metric.init("training", md, md.num_data)
        else:
            for metric in self.training_metrics:
                metric.init("training", train_data.metadata, self.num_data)
        # "auto" follows the telemetry registry (lightgbm_tpu/models/
        # gbdt.py:437-449)
        # in a world whose rows are sharded, the vector is the world's:
        # reduced over the learner's group of those rows
        self._health_monitor = (health.HealthMonitor(
            on_anomaly=boosting_config.on_anomaly,
            divergence_rounds=boosting_config.health_divergence_rounds,
            quantized=is_int8(self.tree_config.compute_dtype),
            comm=learner.comm if self._sharded else None)
            if health.resolve_enabled(boosting_config.health) else None)

    def _plan_packing(self, train_data, learner):
        """The booster's mixed-bin layout (lightgbm_tpu/models/gbdt.py:
        162-219), logged and counted: none under the feature learner
        (its owned features are arbitrary subsets), the block-local plan
        of the learner's ``pack_layout`` under hybrid and voting, else
        the dataset's own plan."""
        mode = self.tree_config.mixed_bin
        if learner is not None and not learner.shards_rows:
            spec = None
            if mode == "true":
                log.warning("mixed_bin is not supported by %s; keeping the "
                            "uniform layout" % type(learner).__name__)
        elif learner is not None and hasattr(learner, "pack_layout"):
            block, shards = learner.pack_layout(train_data.num_features)
            spec = train_data.plan_packing(mode, block=block, shards=shards)
            if spec is None and mode == "true":
                log.warning("mixed_bin=true requested but the block-local "
                            "plan degenerates to the uniform layout "
                            "(single bin-width class, or an ownership "
                            "block without narrow features)")
        else:
            spec = train_data.plan_packing(mode)
        telemetry.count_route("hist_layout", "hist/mixedbin_off"
                              if spec is None else "hist/mixedbin_on")
        if spec is None:
            return None
        passes = "x".join(str(w) for w in spec.widths)
        if hasattr(spec, "block"):
            # the block-local layout files its own marker as well
            telemetry.count("hist/mixedbin_blocked")
            log.info("mixed-bin packing (block-local, block=%d): %d narrow "
                     "(<=%d bins) + %d wide features PER owned block "
                     "(histogram passes per class: %s)"
                     % (spec.block, spec.counts[0], spec.widths[0],
                        spec.counts[1], passes))
        else:
            log.info("mixed-bin packing: %d narrow (<=%d bins) + %d wide "
                     "features (histogram passes per class: %s)"
                     % (spec.counts[0], spec.widths[0], spec.counts[1],
                        passes))
        return spec

    def _check_world(self, bc, train_data, objective) -> None:
        """What a parallel world refuses (module docstring), and a grid's
        feature groups must agree on their rows."""
        if hasattr(self._learner, "agree_rows"):
            self._learner.agree_rows(train_data.num_data)
        if (self._sharded and isinstance(objective, LambdarankNDCG)
                and train_data.metadata.query_boundaries is not None
                and not train_data.shard_query_atomic):
            log.fatal("distributed lambdarank requires query-atomic row "
                      "sharding: supply query ids via a .query side file (an "
                      "in-file group column is extracted after sharding and "
                      "splits queries across machines)")

    def global_num_data(self) -> int:
        """Rows of the world (this booster's own outside a sharded
        world)."""
        return self._rows.n_total if self._rows is not None \
            else self.num_data

    def _in_world(self) -> bool:
        """This booster is one rank of a world of more than one."""
        return self._learner is not None and self._learner.world > 1

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
            # over the world's rows: the serial run's counts
            (self._goss_top_cnt, self._goss_other_cnt,
             self._goss_amp) = sampling.goss_counts(
                self.global_num_data(), bc.top_rate, bc.other_rate)
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
        # a shard bags its own rows with the host draw (gbdt.py:555-575)
        capable = (self.train_data.metadata.query_boundaries is None
                   and not self._sharded)
        if bc.bagging_device == "true":
            if not capable:
                log.warning("bagging_device=true cannot apply here "
                            "(a row shard or per-query bagging); keeping "
                            "the host draw")
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
        the inputs and None when GOSS is off.  A sharded world's ranks
        gather the row scores in serial row order (``SerialRows``, site
        ``dp/goss_score_allgather``), every rank draws the serial run's
        mask over them and keeps its own rows' part."""
        if not self._goss_on:
            return grad, hess, None
        key = threefry.fold_in(self._goss_key, self.iter)
        with telemetry.span("goss") as sp:
            if self._rows is None:
                out = sampling.goss_select(
                    key, grad, hess, self._goss_top_cnt,
                    self._goss_other_cnt, self._goss_amp)
            else:
                absg = self._rows.gather(sampling.goss_row_scores(grad),
                                         "dp/goss_score_allgather")
                mask, w = sampling.goss_mask_weights(
                    key, absg, self._goss_top_cnt, self._goss_other_cnt,
                    self._goss_amp)
                w = self._rows.take(w)
                out = grad * w, hess * w, self._rows.take(mask)
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
        growth policy, or through the parallel learner."""
        if self._learner is not None:
            return self._learner(self, self.bins_device, grad, hess,
                                 row_mask, feature_mask)
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
        writer, the straggler drain (``enable_elastic``) takes its step,
        the fault hatch fires at each boundary, one checkpoint is written
        synchronously at the end and one, best effort, on an exception;
        the writer is always closed.  In a world every rank takes the
        snapshot (a sharded world's is a collective) and the ranks of
        ``_rank_checkpoint_dir`` write it; the exception path runs no
        collective there, since a peer may not come: it keeps the last
        periodic checkpoint.  With ``stall_timeout`` configured the
        telemetry watchdog runs around the loop.  With a sink, the
        summary record closes the run; an exception escaping the loop
        writes it marked ``aborted`` and then dumps the flight recorder's
        ring before re-raising."""
        bc = self.gbdt_config
        wd_armed = telemetry.arm_watchdog()
        if wd_armed:
            telemetry.watchdog_checkin(phase="run_training",
                                       iteration=self.iter)
        writer = None
        ckpt_on = bc.checkpoint_interval > 0
        if ckpt_on:
            log.check(bool(bc.checkpoint_dir),
                      "checkpoint_interval > 0 requires checkpoint_dir")
            ckpt_dir = self._rank_checkpoint_dir(bc.checkpoint_dir)
            if ckpt_dir is not None:
                writer = checkpoint.CheckpointWriter(ckpt_dir,
                                                     keep=bc.checkpoint_keep)
                self.checkpoint_writer = writer
        last_ckpt = self.iter
        mesh.exact_waits(self._straggler is not None)
        self._stamp_boundary()
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
                if ckpt_on and self.iter - last_ckpt >= bc.checkpoint_interval:
                    state = self.checkpoint_state()
                    if writer is not None:
                        writer.submit(state)
                    last_ckpt = self.iter
                if self._straggler is not None:
                    self._elastic_step(ckpt_on, writer)
                faults.maybe_fire(self.iter)
            if ckpt_on:
                # a restart after a clean finish sees the complete run
                state = self.checkpoint_state()
                if writer is not None:
                    writer.write_sync(state)
            if self._learner is not None:
                learners.aggregate_telemetry()
        except BaseException as e:
            if writer is not None and not self._in_world():
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
            mesh.exact_waits(False)
            if writer is not None:
                writer.close()
            if wd_armed:
                telemetry.disarm_watchdog()
        if telemetry.sink_active():
            extra = {"iterations": self.iter}
            if self._health_monitor is not None:
                extra["health"] = self._health_monitor.summary()
            telemetry.emit_summary(extra=extra)

    # ------------------------------------------------------ straggler drain

    def enable_elastic(self) -> None:
        """Arm the straggler drain (lightgbm_tpu/models/gbdt.py:989-1019):
        at every iteration boundary the ranks of a world exchange their
        own work since the last boundary, an ``elastic.StragglerMonitor``
        of ``straggler_k`` reads it through ``elastic.clear_lead``, and a
        flagged rank drains the world (``_elastic_shrink``).  The JAX
        package's learner factory, which re-meshes a single process in
        place, has no counterpart: every world of the port is one process
        a rank, and a live process does not leave a ``torch.distributed``
        group, so the shrink is the multi-process protocol of checkpoint,
        agreement, stop and a restart of the survivors."""
        self._straggler = elastic.StragglerMonitor(
            self.gbdt_config.straggler_k)

    def _stamp_boundary(self) -> None:
        self._boundary_t = time.perf_counter()
        self._boundary_wait = mesh.collective_seconds()

    def _elastic_step(self, ckpt_on: bool, writer) -> None:
        """One boundary of the drain (lightgbm_tpu/models/gbdt.py:
        1021-1044): exchange this rank's own work since the last boundary
        over the world, the interval less its waits in collectives (each
        rank labeled ``p<rank>``; the JAX package exchanges the interval,
        ROADMAP C11), feed the monitor, and drain on a flagged rank."""
        mon = self._straggler
        if self._in_world():
            busy = (time.perf_counter() - self._boundary_t) - (
                mesh.collective_seconds() - self._boundary_wait)
            gathered = elastic.exchange_times(mesh.host_comm(), busy,
                                              iteration=self.iter)
            mon.observe(self.iter, elastic.clear_lead(
                elastic.host_times_from_gather(gathered)))
        self._stamp_boundary()
        flagged = mon.take_flagged()
        if flagged is not None:
            self._elastic_shrink(flagged, ckpt_on, writer)

    def _elastic_shrink(self, flagged: str, ckpt_on: bool, writer) -> None:
        """The multi-process drain (lightgbm_tpu/models/gbdt.py:
        1046-1091): write the world checkpoint, agree on the survivors
        over the world (``elastic.agree_survivors``: every rank names the
        same count) and stop every rank with a ``Fatal`` asking for a
        restart of the survivors from the checkpoint.  A world of one, or
        one without checkpoints, has nothing to restart from: the drain
        warns and disarms, alike on every rank, and training goes on."""
        cur = self._learner.world if self._learner is not None else 1
        if cur <= 1:
            log.warning("persistent straggler %s flagged but the mesh is "
                        "already minimal (num_machines=1); cannot shrink"
                        % flagged)
            self._straggler = None
            return
        if not ckpt_on:
            log.warning("persistent straggler %s flagged, but no checkpoint "
                        "is configured (checkpoint_interval=0) — a "
                        "multi-process shrink restarts survivors from a "
                        "checkpoint, so none can happen; continuing at the "
                        "straggler's pace.  Arm checkpoint_interval/"
                        "checkpoint_dir to make shrinks recoverable."
                        % flagged)
            self._straggler = None
            return
        state = self.checkpoint_state()
        if writer is not None:
            writer.write_sync(state)
        try:
            drop = int(str(flagged).lstrip("p").split("@")[0])
        except ValueError:
            drop = cur - 1
        votes = np.ones(cur, np.int32)
        votes[min(max(drop, 0), cur - 1)] = 0
        agreed = elastic.agree_survivors(mesh.host_comm(), votes,
                                         iteration=self.iter)
        survivors = max(min(int(agreed.sum()), cur - 1), 1)
        telemetry.count("elastic/shrinks")
        if tracing.active():
            tracing.event("elastic_shrink", iter=int(self.iter))
        log.fatal("persistent straggler %s: checkpoint written at iteration "
                  "%d; multi-process mesh shrink requires restarting the %d "
                  "surviving processes from the checkpoint (task=train, "
                  "same checkpoint_dir)" % (flagged, self.iter, survivors))

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
        """The dataset's identity: the world's rows, feature counts,
        validation sets (lightgbm_tpu/models/gbdt.py:805-815)."""
        return {
            "num_features": int(self.train_data.num_features),
            "num_total_features": int(self.train_data.num_total_features),
            "num_rows": int(self.global_num_data()),
            "num_valid": len(self.valid_datasets),
        }

    def _topology_info(self) -> dict:
        """The learner's class name, its world (``num_machines``) and the
        ranks of the process group (lightgbm_tpu/models/gbdt.py:
        817-827); a pre-partitioned world adds ``row_order: rank``, its
        scores being in rank order, not serial order."""
        if self._learner is None:
            return {"tree_learner": "serial", "num_machines": 1,
                    "process_count": 1}
        # one process a rank
        out = {"tree_learner": type(self._learner).__name__,
               "num_machines": int(self._learner.world),
               "process_count": int(self._learner.world)}
        if self._rows is not None and self._rows.rank_order:
            out["row_order"] = "rank"
        return out

    def _topology_changed(self, topo: dict) -> bool:
        """A checkpoint's topology differs from this run's.  Two runs of
        one process each are one layout (serial row order) whatever their
        learner."""
        here = self._topology_info()
        if int(topo.get("process_count", 1)) <= 1 \
                and here["process_count"] <= 1:
            return False
        return any(topo.get(k) != here.get(k) for k in
                   ("tree_learner", "num_machines", "process_count",
                    "row_order"))

    def _rank_checkpoint_dir(self, directory: str) -> Optional[str]:
        """Where this rank writes its checkpoints: rank 0 (and one
        process) ``directory``, field for field the JAX payload; rank
        r > 0 of a sharded world with host bagging, whose bagging state is
        its own, ``directory/rank<r>``; None for any other rank, which
        writes nothing and reads rank 0's files.  No two ranks write one
        path, so no writer prunes a file another rank reads."""
        rank = mesh.get_rank() if self._in_world() else 0
        if rank == 0:
            return directory
        if self._sharded and self._use_bagging and not self._bag_device:
            return os.path.join(directory, "rank%d" % rank)
        return None

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
        copy taken here is ordered after every queued update.  A sharded
        world's scores are gathered into serial row order (one
        collective, site ``ckpt/score_allgather``: every rank calls this
        at the same iteration), so its checkpoint is a serial run's."""
        return {
            "iteration": int(self.iter),
            "num_class": int(self.num_class),
            "models": tuple(self.models),
            "best_score": [list(r) for r in self.best_score],
            "best_iter": [list(r) for r in self.best_iter],
            "rng": self._rng_snapshot(),
            "score": self._serial_score(),
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
        The scores are stored in serial row order, so a rank of a
        sharded world takes its own rows (``used_data_indices``) on any
        topology, and a world's checkpoint and a serial one are
        interchangeable; what cannot cross a topology change is refused
        (``_check_topology``).  The incremental model file starts over,
        so a resumed CLI run writes the whole model again."""
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
        self._check_topology(payload)
        stored = checkpoint.array_from_json(payload["score"])
        n_true = self.global_num_data()
        if tuple(stored.shape) != (self.num_class, n_true):
            log.fatal("checkpoint field 'score' has shape %s, this run "
                      "needs (%d, %d)" % (tuple(stored.shape),
                                          self.num_class, n_true))
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
        if self._rows is not None:
            # the stored scores are the world's in serial row order: this
            # rank's rows, wherever the checkpoint's world held them
            self.score = self._rows.take(self.score).contiguous()
        for entry, sj in zip(self.valid_datasets, vs):
            entry["score"] = torch.as_tensor(checkpoint.array_from_json(sj),
                                             device=self.device)
        if self._model_file is not None and not self._model_file.closed:
            self._model_file.close()
        self._saved_model_size = -1
        self._model_file = None
        log.info("restored checkpoint at iteration %d (%d trees)"
                 % (self.iter, len(self.models)))

    def _check_topology(self, payload) -> None:
        """The elastic restart's rules (lightgbm_tpu/models/gbdt.py:
        897-903, 958-987): a changed ``num_machines`` is logged; across a
        topology change a pre-partitioned run (scores in rank order, each
        rank its own file) and host-stream bagging (one state a shard)
        cannot continue, each a named ``Fatal``."""
        topo = payload.get("topology", {})
        here = self._topology_info()
        if topo.get("num_machines") not in (None, here["num_machines"]):
            log.info("elastic restart: checkpoint topology "
                     "num_machines=%s -> %s (mesh re-factored on the "
                     "surviving machine count)"
                     % (topo.get("num_machines"), here["num_machines"]))
        if not self._topology_changed(topo):
            return
        if "row_order" in topo or "row_order" in here:
            log.fatal("is_pre_partition=true cannot resume across a "
                      "topology change: the checkpoint of tree_learner=%s "
                      "on %s process(es) holds its scores in the rank order "
                      "of its own files, and this run (tree_learner=%s on "
                      "%d process(es)) has no serial row order to place "
                      "them by; restart on the checkpoint's topology"
                      % (topo.get("tree_learner"), topo.get("process_count"),
                         here["tree_learner"], here["process_count"]))
        bag = payload["rng"]["bagging"]
        if bag is not None and bag["mode"] == "host" and (
                self._sharded
                or checkpoint.mask_from_json(bag["mask"]).size
                != self.num_data):
            log.fatal("checkpoint rng field 'bagging' is the host draw of "
                      "tree_learner=%s on %s process(es), this run is "
                      "tree_learner=%s on %d — host-path bagging state is "
                      "per-shard, so an elastic restart across a different "
                      "process layout cannot continue it (restart on the "
                      "checkpoint's topology, or without bagging)"
                      % (topo.get("tree_learner"), topo.get("process_count"),
                         here["tree_learner"], here["process_count"]))

    def _serial_score(self) -> np.ndarray:
        """A host copy of the [K, N] training score, of the world's rows
        in serial row order in a sharded world (collective there)."""
        if self._rows is None:
            return self.score.to("cpu", copy=True).numpy()
        return self._rows.gather(self.score, "ckpt/score_allgather") \
            .to("cpu").numpy()

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
        (lightgbm_tpu/cli.py:368-378).  In a world every rank reads its
        own (``_rank_checkpoint_dir``, else rank 0's files); the ranks
        all-gather the iterations each can resume from and take the
        latest they share, or stop with a ``Fatal`` naming each rank's
        (collective)."""
        if not directory:
            return
        if not self._in_world():
            latest = checkpoint.latest_checkpoint(directory)
            if latest is not None:
                log.info("resuming from checkpoint %s" % latest)
                self.restore_checkpoint(latest)
            return
        own = self._rank_checkpoint_dir(directory) or directory
        found = _iterations(own)
        if own != directory:
            found = sorted(set(found) & set(_iterations(directory)))
        everyone = mesh.all_gather_object(found)
        if not any(everyone):
            return
        common = set(everyone[0]).intersection(*everyone[1:])
        if not common:
            latest = checkpoint.latest_checkpoint(directory)
            if latest is not None:
                # the named cause, where a topology change is it
                self._check_topology(_load(latest))
            log.fatal("the ranks hold no common checkpoint iteration to "
                      "resume from in %s: %s" % (directory, "; ".join(
                          "rank %d: %s" % (r, ", ".join(map(str, its))
                                           or "none")
                          for r, its in enumerate(everyone))))
        path = checkpoint.checkpoint_path(own, max(common))
        t0 = time.perf_counter()
        log.info("resuming from checkpoint %s" % path)
        self.restore_checkpoint(_load(path))
        log.info("checkpoint restore took %.3f s" % (time.perf_counter()
                                                     - t0))

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
            score = self._world_score()
            train_vals = [m.eval(flat(score))
                          for m in self.training_metrics]
        if valid:
            valid_vals = [[m.eval(flat(e["score"])) for m in metrics]
                          for e, metrics in zip(self.valid_datasets,
                                                self.valid_metrics)]
        return train_vals, valid_vals

    def _row_step(self) -> int:
        """Ranks that hold the same rows (a grid's feature group)."""
        return getattr(self._learner, "row_step", 1)

    def _world_score(self) -> torch.Tensor:
        """The [K, N] training score, of the world's rows in the world's
        row order (``SerialRows``) when this booster holds a shard
        (collective then)."""
        if self._rows is None:
            return self.score
        rows = self._rows.gather_host(self.score.cpu().numpy().T)
        return torch.from_numpy(np.ascontiguousarray(rows.T))

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
        if getattr(self, "score", None) is None:
            return self.score_reference
        from ..monitor import ScoreHistogram
        score = self._world_score()
        values = score.detach().to("cpu").numpy().astype(np.float64)
        values = values.ravel()
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


class SerialRows:
    """Where the rows of a sharded world's ranks sit in the world's row
    order: serial row order (the order of the rows in the file, the
    serial run's), each rank holding ``used_data_indices`` of the whole
    table.  Under ``is_pre_partition`` a rank's file has no place in a
    serial order, and the layout is rank order (``rank_order``), the JAX
    package's.  Built once a booster (collective: every rank at
    ``init``), from each data shard once (``step``: a grid's feature
    group holds the same rows).  The metrics, the score reference, GOSS
    and the checkpoints all read the world's rows through it.

    ``gather`` all-gathers a row-aligned [..., n] tensor over ``comm``
    (the learner's data-shard group, one shard a rank), padded to the
    largest shard, and places every shard's values at their positions:
    [..., n_total], the same on every rank.  ``take`` is its inverse for
    this rank: its own rows of a [..., n_total] tensor.  Their index
    tensors go to the device on first use.  ``gather_host`` places a
    host array's rows (axis 0) alike, over the bootstrap group."""

    def __init__(self, comm, train_data, step: int, device):
        n = int(train_data.num_data)
        own = train_data.used_data_indices
        self.rank_order = own is None
        if self.rank_order:
            counts = mesh.all_gather_object(n)[::step]
            shard = mesh.get_rank() // step
            parts = [np.arange(sum(counts[:d]), sum(counts[:d + 1]))
                     for d in range(len(counts))]
            own = parts[shard]
        else:
            parts = mesh.all_gather_object(np.asarray(own, np.int64))[::step]
        self.counts = [p.size for p in parts]
        self.n_total = int(sum(self.counts))
        self.width = max(self.counts)
        self.comm, self.step, self.device = comm, step, device
        self._dst = np.concatenate(parts)
        self._own = np.asarray(own, np.int64)
        self._index = None      # (src, dst, own) on the device

    def _device_index(self):
        if self._index is None:
            src = np.concatenate([d * self.width + np.arange(c)
                                  for d, c in enumerate(self.counts)])
            self._index = tuple(torch.as_tensor(a, device=self.device)
                                for a in (src, self._dst, self._own))
        return self._index

    def gather(self, values: torch.Tensor, site: str) -> torch.Tensor:
        src, dst, _ = self._device_index()
        n = values.shape[-1]
        lead = tuple(values.shape[:-1])
        padded = values.new_zeros(lead + (self.width,))
        padded[..., :n] = values
        got = self.comm.all_gather(padded, site)     # [shards, ..., width]
        flat = got.movedim(0, -2).reshape(lead + (-1,))
        out = values.new_empty(lead + (self.n_total,))
        out[..., dst] = flat[..., src]
        return out

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return full[..., self._device_index()[2]]

    def gather_host(self, local) -> np.ndarray:
        local = np.asarray(local)
        rows = np.concatenate(mesh.all_gather_object(local)[::self.step],
                              axis=0)
        out = np.empty_like(rows)
        out[self._dst] = rows
        return out


def _iterations(directory: str) -> List[int]:
    """The iterations of the finished checkpoints in ``directory``."""
    return [int(os.path.basename(p)[5:13])
            for p in checkpoint.list_checkpoints(directory)]


def _load(path: str) -> dict:
    """A checkpoint file's verified payload; its fault a ``Fatal``."""
    try:
        return checkpoint.load_checkpoint(path)
    except checkpoint.CheckpointError as e:
        log.fatal(str(e))


def _start_score(init_score, num_class: int, num_data: int) -> np.ndarray:
    """[K, N] f32 starting score: the rows' initial scores tiled over the
    K classes (gbdt.py:319-322, 534-537), else zeros."""
    if init_score is None:
        return np.zeros((num_class, num_data), np.float32)
    return np.tile(np.asarray(init_score, np.float32), (num_class, 1))
