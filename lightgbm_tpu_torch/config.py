"""Configuration: the subset of lightgbm_tpu/config.py the port runs.

Same parameter names, aliases (lightgbm_tpu/config.py:26-84), defaults
and conflict rules (``_check_param_conflict``, :972-985) for the keys of
the reference's four ``task=train`` / ``task=predict`` examples: the
objectives regression, binary, multiclass (``num_class``) and lambdarank
(``label_gain``, ``max_position``) and their eight metrics
(``ndcg_eval_at``), row and feature sampling (bagging, GOSS,
``feature_fraction``), early stopping, continued training
(``input_model`` under ``task=train``), ``input_init_score``, the
mixed-bin layout (``mixed_bin``) and every histogram mode
(``hist_dtype`` float32, bfloat16 and int8, ``quant_rounding`` nearest
and stochastic), the serving engine's ``predict_*`` keys with
``predict_leaf_index`` and ``serve_shards``, and the ingest keys: the
column selectors, caches, two-round and streamed loads, parse workers,
``num_threads``;
checkpoints (``checkpoint_interval``, ``checkpoint_dir``,
``checkpoint_keep``), ``device_type`` and ``histogram_pool_size``; and
observability on one process: the telemetry sink (``metrics_out``,
``metrics_fence``, ``memory_stats``, ``profile_dir``), the flight
recorder (``trace_*``, ``stall_timeout``), training health
(``health``, ``on_anomaly``, ``health_divergence_rounds``) and the live
monitor (``monitor_*``, ``slo_*``), and over a world the leader-only
sink or ``timeline`` shards (``IOConfig.timeline_enabled``); and the
reference's two parallel learners (parallel/): ``tree_learner`` serial,
data, feature, hybrid or voting (``voting_parallel``), ``num_machines``,
``dp_schedule``, ``feature_shards``, ``top_k``, ``is_pre_partition``, and
``machine_list_file``, ``local_listen_port`` and ``time_out``, which
are checked as the JAX package checks them and have no effect (torch's
environment does their work, parallel/mesh.py); and the straggler
drain (``elastic_shrink``, ``straggler_k``, elastic.py); and
``pipeline`` (auto, off or readback), checked and resolved as the JAX
package does, with the loop kept synchronous.  As in the JAX package,
``num_machines`` of 1 makes any learner serial.
The difference is the slice rule: a key the port does not run raises
``Fatal`` naming it, instead of being parsed and silently ignored.
Keys whose JAX-package default is the only value the port runs
(``boosting_type``) are accepted at that value and refused at any other.
Growth runs under all three policies of the JAX package: compacted
leaf-wise (the default), masked leaf-wise (``leafwise_compact=false``)
and depth-wise (``grow_policy=depthwise``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

from .utils import log

# lightgbm_tpu/config.py:26-84, restricted to the keys of this slice
ALIAS_TABLE: Dict[str, str] = {
    "config": "config_file",
    "nthread": "num_threads",
    "num_thread": "num_threads",
    "boosting": "boosting_type",
    "boost": "boosting_type",
    "application": "objective",
    "app": "objective",
    "train_data": "data",
    "train": "data",
    "model_output": "output_model",
    "model_out": "output_model",
    "model_input": "input_model",
    "model_in": "input_model",
    "init_score": "input_init_score",
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "is_sparse": "is_enable_sparse",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
    "ndcg_at": "ndcg_eval_at",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "num_leaf": "num_leaves",
    "sub_feature": "feature_fraction",
    "num_iteration": "num_iterations",
    "num_tree": "num_iterations",
    "num_round": "num_iterations",
    "num_trees": "num_iterations",
    "num_rounds": "num_iterations",
    "sub_row": "bagging_fraction",
    "shrinkage_rate": "learning_rate",
    "tree": "tree_learner",
    "num_machine": "num_machines",
    "local_port": "local_listen_port",
    "mlist": "machine_list_file",
    "topk": "top_k",
    "two_round_loading": "use_two_round_loading",
    "two_round": "use_two_round_loading",
    "is_save_binary": "is_save_binary_file",
    "save_binary": "is_save_binary_file",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
    "label": "label_column",
    "weight": "weight_column",
    "group": "group_column",
    "query": "group_column",
    "query_column": "group_column",
    "ignore_feature": "ignore_column",
    "blacklist": "ignore_column",
}

# keys this slice runs at any valid value
SLICE_KEYS = frozenset((
    "config_file", "task", "data", "valid_data", "input_model",
    "output_model", "output_result", "objective", "metric",
    "num_iterations", "learning_rate", "num_leaves", "max_depth",
    "min_data_in_leaf", "min_sum_hessian_in_leaf", "max_bin", "sigmoid",
    "is_unbalance", "hist_dtype", "quant_rounding", "device",
    "data_random_seed", "verbose", "metric_freq", "is_training_metric",
    "has_header", "is_sigmoid", "num_model_predict", "grow_policy",
    "leafwise_compact", "hist_chunk", "leafwise_segments", "num_class",
    "label_gain", "max_position", "ndcg_eval_at",
    # sampling, early stopping and initial scores
    "bagging_fraction", "bagging_freq", "bagging_seed", "bagging_device",
    "feature_fraction", "feature_fraction_seed", "goss", "top_rate",
    "other_rate", "early_stopping_round", "input_init_score",
    # the histogram's layout
    "mixed_bin",
    # the serving engine (serving.py)
    "predict_leaf_index", "predict_buckets", "predict_quantize",
    "predict_donate", "predict_algo", "predict_linger_us", "predict_queue",
    "serve_shards",
    # the ingest layer (io/): column selectors, caches, two-round and
    # streamed loads, the native parser's thread cap
    "label_column", "weight_column", "group_column", "ignore_column",
    "use_two_round_loading", "is_save_binary_file", "save_binary_format",
    "streaming", "ingest_chunk_rows", "ingest_workers", "num_threads",
    "is_enable_sparse",
    # checkpoints and resume (checkpoint.py)
    "checkpoint_interval", "checkpoint_dir", "checkpoint_keep",
    # the device (cpu, or the card as gpu/cuda) and the JAX package's
    # histogram pool key (checked, no effect)
    "device_type", "histogram_pool_size",
    # observability (telemetry.py, tracing.py, health.py, monitor.py)
    "profile_dir", "metrics_out", "metrics_fence", "memory_stats",
    "timeline", "stall_timeout", "trace_ring_events", "trace_dump_dir",
    "trace_sketch_growth", "trace_run_id", "monitor_out",
    "monitor_interval_s", "slo_p99_us", "slo_window_s", "health",
    "on_anomaly", "health_divergence_rounds",
    # pipelined boosting (checked, resolved and logged; the loop stays
    # synchronous)
    "pipeline",
    # the parallel learners (parallel/); the last three have no effect
    "tree_learner", "num_machines", "dp_schedule", "is_pre_partition",
    "feature_shards", "top_k",
    "machine_list_file", "local_listen_port", "time_out",
    # the straggler drain (elastic.py)
    "elastic_shrink", "straggler_k",
))

# device_type values and the device each names (device.py's rule)
DEVICE_TYPES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

OBJECTIVES = ("regression", "binary", "multiclass", "lambdarank")

# metric.cpp:9-28
METRICS = ("l1", "l2", "binary_logloss", "binary_error", "auc", "ndcg",
           "multi_logloss", "multi_error")

# keys of the JAX package whose default is the only value the slice runs
DEFAULT_ONLY = {
    "boosting_type": ("gbdt", "gbrt"),
}


def apply_aliases(params: Dict[str, str]) -> Dict[str, str]:
    """KeyAliasTransform (config.h:302-373): canonical key wins."""
    out = dict(params)
    for key, value in params.items():
        canon = ALIAS_TABLE.get(key)
        if canon is not None and canon not in out:
            out[canon] = value
    return {k: v for k, v in out.items() if k not in ALIAS_TABLE}


def check_slice(params: Dict[str, str]) -> None:
    """Refuse every key (or value) this port slice does not run."""
    for key, value in params.items():
        if key in SLICE_KEYS:
            continue
        allowed = DEFAULT_ONLY.get(key)
        if allowed is None:
            log.fatal("Parameter %s is not supported by lightgbm_tpu_torch "
                      "(outside the ported slice)" % key)
        if str(value).strip().lower() not in allowed:
            log.fatal("Parameter %s=%s is not supported by "
                      "lightgbm_tpu_torch (the ported slice runs only %s)"
                      % (key, value, "/".join(allowed)))


def _get_int(params, name, default):
    if name in params:
        try:
            return int(params[name])
        except ValueError:
            log.fatal("Parameter %s should be int type, passed is [%s]"
                      % (name, params[name]))
    return default


def _get_float(params, name, default):
    if name in params:
        try:
            return float(params[name])
        except ValueError:
            log.fatal("Parameter %s should be double type, passed is [%s]"
                      % (name, params[name]))
    return default


def _get_bool(params, name, default):
    if name in params:
        value = params[name].lower()
        if value in ("false", "-"):
            return False
        if value in ("true", "+"):
            return True
        log.fatal('Parameter %s should be "true"/"+" or "false"/"-", '
                  'passed is [%s]' % (name, params[name]))
    return default


@dataclasses.dataclass
class IOConfig:
    """lightgbm_tpu/config.py IOConfig, slice subset."""
    max_bin: int = 256
    data_random_seed: int = 1
    data_filename: str = ""
    valid_data_filenames: List[str] = dataclasses.field(default_factory=list)
    output_model: str = "LightGBM_model.txt"
    output_result: str = "LightGBM_predict_result.txt"
    input_model: str = ""
    input_init_score: str = ""
    verbosity: int = 1
    has_header: bool = False
    is_sigmoid: bool = True
    num_model_predict: int = -1
    # each rank's data file is already its shard (no shard draw)
    is_pre_partition: bool = False
    # the serving engine (serving.py; lightgbm_tpu/config.py:209-255):
    # the ladder of batch shapes a batch is padded to, the leaf table
    # ("float32", or "int8" with a per-tree scale), buffer donation
    # (checked; no torch counterpart), the walk ("bfs", breadth-first, or
    # "scan", the per-tree replay), the tree shards (0/1 one device; > 1
    # one device per contiguous tree block, bfs only), and the
    # ServingFront's coalescing wait and queue bound in top-bucket batches
    # (also predict_file's chunks parsed ahead)
    predict_buckets: str = "1,32,1024,65536"
    predict_quantize: str = "float32"
    predict_donate: str = "auto"
    predict_algo: str = "bfs"
    serve_shards: int = 0
    predict_linger_us: int = 200
    predict_queue: int = 4
    # the ingest layer (lightgbm_tpu/config.py:256-285): "auto" streams a
    # data or cache file of at least 256 MB (io/streaming.py), chunks of
    # ingest_chunk_rows rows, parsed by ingest_workers byte-range worker
    # processes when > 1 ("auto" = cpu_count); the cache format written by
    # is_save_binary_file; the column selectors, by index or "name:"
    is_enable_sparse: bool = True
    streaming: str = "auto"
    ingest_chunk_rows: int = 200_000
    ingest_workers: int = 1
    use_two_round_loading: bool = False
    is_save_binary_file: bool = False
    save_binary_format: str = "native"
    label_column: str = ""
    weight_column: str = ""
    group_column: str = ""
    ignore_column: str = ""
    # observability (lightgbm_tpu/config.py:138-208): a torch.profiler
    # Chrome trace of the training loop; the per-iteration JSONL sink,
    # its event-timed device spans and memory gauges ("auto": on with a
    # sink); the timeline shard mode (timeline_enabled); the stall watchdog's
    # timeout (0 off); the flight recorder's ring, dump
    # directory, sketch growth and run tag; the live monitor's JSONL and
    # window, and the serving SLO's p99 target (0 off) and budget window
    profile_dir: str = ""
    metrics_out: str = ""
    metrics_fence: bool = False
    memory_stats: str = "auto"
    timeline: str = "auto"
    stall_timeout: float = 0.0
    trace_ring_events: int = 65536
    trace_dump_dir: str = ""
    trace_sketch_growth: float = 1.05
    trace_run_id: str = ""
    monitor_out: str = ""
    monitor_interval_s: float = 1.0
    slo_p99_us: float = 0.0
    slo_window_s: float = 60.0

    def memory_stats_enabled(self) -> bool:
        """``memory_stats=``: "auto" follows the sink, "true"/"false"
        force (lightgbm_tpu/config.py:301-306)."""
        return (self.memory_stats == "true"
                or (self.memory_stats == "auto" and bool(self.metrics_out)))

    def timeline_enabled(self) -> bool:
        """``timeline=`` (lightgbm_tpu/config.py:308-325): "auto" turns a
        shard a rank on for a world of more than one rank with a sink,
        "true" turns it on even for one process, "false" keeps the
        leader-only sink.  Read once the world has formed
        (``telemetry.resolve_world``), when its size is final."""
        if self.timeline == "true":
            return True
        if self.timeline != "auto" or not self.metrics_out:
            return False
        from .parallel import mesh
        return mesh.get_num_machines() > 1

    def predict_bucket_list(self) -> tuple:
        """The ``predict_buckets=`` ladder: sorted unique positive ints
        (lightgbm_tpu/config.py:287-298)."""
        try:
            buckets = tuple(sorted({int(b) for b in
                                    self.predict_buckets.split(",") if b}))
        except ValueError:
            log.fatal("predict_buckets should be comma-separated ints, "
                      "passed is [%s]" % self.predict_buckets)
        log.check(bool(buckets) and buckets[0] >= 1,
                  "predict_buckets must contain positive ints")
        return buckets

    def set(self, params: Dict[str, str], require_data: bool = True) -> None:
        self.max_bin = _get_int(params, "max_bin", self.max_bin)
        log.check(self.max_bin > 0, "max_bin should be > 0")
        self.data_random_seed = _get_int(params, "data_random_seed",
                                         self.data_random_seed)
        if "data" in params:
            self.data_filename = params["data"]
        elif require_data:
            log.fatal("No training/prediction data, application quit")
        if "valid_data" in params:
            self.valid_data_filenames = [
                p for p in params["valid_data"].split(",") if p]
        self.output_model = params.get("output_model", self.output_model)
        self.output_result = params.get("output_result", self.output_result)
        self.input_model = params.get("input_model", self.input_model)
        self.input_init_score = params.get("input_init_score",
                                           self.input_init_score)
        self.verbosity = _get_int(params, "verbose", self.verbosity)
        self.has_header = _get_bool(params, "has_header", self.has_header)
        self.is_sigmoid = _get_bool(params, "is_sigmoid", self.is_sigmoid)
        self.num_model_predict = _get_int(params, "num_model_predict",
                                          self.num_model_predict)
        self.is_pre_partition = _get_bool(params, "is_pre_partition",
                                          self.is_pre_partition)
        # lightgbm_tpu/config.py:406-438
        self.predict_buckets = params.get("predict_buckets",
                                          self.predict_buckets)
        self.predict_bucket_list()  # validate eagerly: fail at parse time
        if "predict_quantize" in params:
            value = params["predict_quantize"].lower()
            log.check(value in ("float32", "int8"),
                      "predict_quantize must be float32 or int8")
            self.predict_quantize = value
        if "predict_donate" in params:
            value = params["predict_donate"].lower()
            log.check(value in ("auto", "true", "false"),
                      "predict_donate must be auto, true or false")
            self.predict_donate = value
        if "predict_algo" in params:
            value = params["predict_algo"].lower()
            log.check(value in ("bfs", "scan"),
                      "predict_algo must be bfs or scan")
            self.predict_algo = value
        self.serve_shards = _get_int(params, "serve_shards",
                                     self.serve_shards)
        log.check(self.serve_shards >= 0,
                  "serve_shards should be >= 0 (0 = single-device)")
        if self.serve_shards > 1 and self.predict_algo == "scan":
            log.fatal("serve_shards > 1 requires predict_algo=bfs (the "
                      "per-tree scan replay is a single-device A/B path)")
        self.predict_linger_us = _get_int(params, "predict_linger_us",
                                          self.predict_linger_us)
        log.check(self.predict_linger_us >= 0,
                  "predict_linger_us should be >= 0")
        self.predict_queue = _get_int(params, "predict_queue",
                                      self.predict_queue)
        log.check(self.predict_queue >= 1,
                  "predict_queue should be >= 1 (in-flight batches)")
        # lightgbm_tpu/config.py:439-477
        self.is_enable_sparse = _get_bool(params, "is_enable_sparse",
                                          self.is_enable_sparse)
        if "streaming" in params:
            value = params["streaming"].lower()
            log.check(value in ("auto", "true", "false"),
                      "streaming must be auto, true or false")
            self.streaming = value
        self.ingest_chunk_rows = _get_int(params, "ingest_chunk_rows",
                                          self.ingest_chunk_rows)
        log.check(self.ingest_chunk_rows > 0,
                  "ingest_chunk_rows should be > 0")
        if str(params.get("ingest_workers", "")).lower() == "auto":
            self.ingest_workers = os.cpu_count() or 1
        else:
            self.ingest_workers = _get_int(params, "ingest_workers",
                                           self.ingest_workers)
        log.check(self.ingest_workers > 0,
                  "ingest_workers should be > 0 (or auto = cpu_count)")
        self.use_two_round_loading = _get_bool(
            params, "use_two_round_loading", self.use_two_round_loading)
        self.is_save_binary_file = _get_bool(params, "is_save_binary_file",
                                             self.is_save_binary_file)
        if "save_binary_format" in params:
            value = params["save_binary_format"].lower()
            log.check(value in ("native", "reference"),
                      "save_binary_format must be native or reference")
            self.save_binary_format = value
        for key in ("label_column", "weight_column", "group_column",
                    "ignore_column"):
            setattr(self, key, params.get(key, getattr(self, key)))
        self._set_observability(params)

    def _set_observability(self, params: Dict[str, str]) -> None:
        """The observability keys, with lightgbm_tpu/config.py:334-404's
        checks and messages."""
        self.profile_dir = params.get("profile_dir", self.profile_dir)
        self.metrics_out = params.get("metrics_out", self.metrics_out)
        self.metrics_fence = _get_bool(params, "metrics_fence",
                                       self.metrics_fence)
        if "memory_stats" in params:
            value = params["memory_stats"].lower()
            log.check(value in ("auto", "true", "false"),
                      "memory_stats must be auto, true or false")
            self.memory_stats = value
        if "timeline" in params:
            value = params["timeline"].lower()
            log.check(value in ("auto", "true", "false"),
                      "timeline must be auto, true or false")
            self.timeline = value
        self.stall_timeout = _get_float(params, "stall_timeout",
                                        self.stall_timeout)
        log.check(self.stall_timeout >= 0.0,
                  "stall_timeout should be >= 0")
        self.trace_ring_events = _get_int(params, "trace_ring_events",
                                          self.trace_ring_events)
        log.check(self.trace_ring_events > 0,
                  "trace_ring_events should be > 0 (preallocated "
                  "flight-recorder ring slots)")
        if "trace_dump_dir" in params:
            self.trace_dump_dir = params["trace_dump_dir"]
            if self.trace_dump_dir:
                # a dump dir that cannot take writes would fail silently
                # at the one moment it matters, inside a crash dump
                try:
                    os.makedirs(self.trace_dump_dir, exist_ok=True)
                except OSError:
                    pass
                log.check(os.path.isdir(self.trace_dump_dir)
                          and os.access(self.trace_dump_dir, os.W_OK),
                          "trace_dump_dir must be a writable directory")
        self.trace_sketch_growth = _get_float(params, "trace_sketch_growth",
                                              self.trace_sketch_growth)
        log.check(1.0005 <= self.trace_sketch_growth <= 2.0,
                  "trace_sketch_growth should be in [1.0005, 2.0]")
        if "trace_run_id" in params:
            value = str(params["trace_run_id"])
            log.check(len(value) <= 128
                      and not any(c.isspace() for c in value),
                      "trace_run_id must be <= 128 chars with no "
                      "whitespace (it lands verbatim in dump headers "
                      "and report keys)")
            self.trace_run_id = value
        if "monitor_out" in params:
            self.monitor_out = params["monitor_out"]
            if self.monitor_out:
                parent = os.path.dirname(self.monitor_out) or "."
                log.check(os.path.isdir(parent)
                          and os.access(parent, os.W_OK),
                          "monitor_out parent must be a writable "
                          "directory")
        self.monitor_interval_s = _get_float(params, "monitor_interval_s",
                                             self.monitor_interval_s)
        log.check(self.monitor_interval_s > 0.0,
                  "monitor_interval_s should be > 0 (the windowed-"
                  "snapshot interval)")
        self.slo_p99_us = _get_float(params, "slo_p99_us", self.slo_p99_us)
        log.check(self.slo_p99_us >= 0.0,
                  "slo_p99_us should be >= 0 (0 disables SLO tracking)")
        self.slo_window_s = _get_float(params, "slo_window_s",
                                       self.slo_window_s)
        log.check(self.slo_window_s > 0.0,
                  "slo_window_s should be > 0 (the error-budget window)")


def _get_num_class(params, default):
    value = _get_int(params, "num_class", default)
    log.check(value >= 1, "num_class should be >= 1")
    return value


def _default_label_gain() -> List[float]:
    # label_gain = 2^i - 1 up to 31 labels (config.cpp:226-232)
    return [0.0] + [float((1 << i) - 1) for i in range(1, 31)]


def _parse_label_gain(value: str) -> List[float]:
    """The comma-separated label_gain list, a Fatal on a junk token."""
    try:
        return [float(x) for x in value.split(",") if x]
    except ValueError:
        log.fatal("Parameter label_gain should be comma-separated "
                  "doubles, passed is [%s]" % value)


@dataclasses.dataclass
class ObjectiveConfig:
    """lightgbm_tpu/config.py ObjectiveConfig (:484-502)."""
    sigmoid: float = 1.0
    label_gain: List[float] = dataclasses.field(
        default_factory=_default_label_gain)
    max_position: int = 20
    is_unbalance: bool = False
    num_class: int = 1

    def set(self, params: Dict[str, str]) -> None:
        self.is_unbalance = _get_bool(params, "is_unbalance",
                                      self.is_unbalance)
        self.sigmoid = _get_float(params, "sigmoid", self.sigmoid)
        self.max_position = _get_int(params, "max_position",
                                     self.max_position)
        log.check(self.max_position > 0, "max_position should be > 0")
        self.num_class = _get_num_class(params, self.num_class)
        if "label_gain" in params:
            self.label_gain = _parse_label_gain(params["label_gain"])


@dataclasses.dataclass
class MetricConfig:
    """lightgbm_tpu/config.py MetricConfig (:516-533)."""
    num_class: int = 1
    sigmoid: float = 1.0
    label_gain: List[float] = dataclasses.field(
        default_factory=_default_label_gain)
    eval_at: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 3, 4, 5])

    def set(self, params: Dict[str, str]) -> None:
        self.sigmoid = _get_float(params, "sigmoid", self.sigmoid)
        self.num_class = _get_num_class(params, self.num_class)
        if "label_gain" in params:
            self.label_gain = _parse_label_gain(params["label_gain"])
        if "ndcg_eval_at" in params:
            try:
                self.eval_at = sorted(
                    int(x) for x in params["ndcg_eval_at"].split(",") if x)
            except ValueError:
                log.fatal("Parameter ndcg_eval_at should be comma-separated "
                          "ints, passed is [%s]" % params["ndcg_eval_at"])
            for k in self.eval_at:
                log.check(k > 0, "ndcg_eval_at should be > 0")


@dataclasses.dataclass
class TreeConfig:
    """lightgbm_tpu/config.py TreeConfig (:537-696), slice subset."""
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    num_leaves: int = 127
    feature_fraction_seed: int = 2
    feature_fraction: float = 1.0
    max_depth: int = -1
    hist_dtype: str = "float32"
    # int8 rounding: "nearest", or "stochastic" — unbiased floor(y + u)
    # with value-keyed uniform bits (ops/hist_cuda.stochastic_bits)
    quant_rounding: str = "nearest"
    # mixed-bin layout (io/binning.plan_feature_packing): "auto"/"true"
    # pack narrow and wide features into classes whenever the dataset has
    # both, "false" keeps the uniform layout; trees are the same
    mixed_bin: str = "auto"
    # "leafwise": best-first growth; "depthwise": level-batched growth
    # (models/grower_depthwise.py), whatever leafwise_compact says
    grow_policy: str = "leafwise"
    # leaf-wise growth through the plane pane ("auto", "true") or the
    # masked leaf-id vector ("false").  "auto" is the compacted grower,
    # as the JAX package resolves it on an accelerator
    leafwise_compact: str = "auto"
    # accepted and validated as in the JAX package, with no effect: there
    # it sets the row chunk of the XLA histogram scans, which this port
    # does not have (its kernel takes whole passes); trees are the same
    hist_chunk: int = 0
    # accepted and validated as in the JAX package, with no effect: there
    # it splits one masked tree across several dispatches of the same
    # loop; here the loop is eager Python, so there is nothing to split
    leafwise_segments: int = 1
    # parsed as in the JAX package, with no effect: the JAX package reads
    # it only to warn under its parallel learners (config.py:1011-1016),
    # which the port does not run; every leaf's histogram is kept
    histogram_pool_size: float = -1.0
    # the data-parallel histogram reduction (parallel/learners.py): psum,
    # reduce_scatter, or auto (reduce_scatter in a world of more than one
    # rank, else psum)
    dp_schedule: str = "auto"
    # the hybrid and voting learners' grid of ranks (parallel/mesh.
    # factor_machines): num_machines = data shards x feature_shards; 0 is
    # auto (hybrid the largest divisor <= sqrt(num_machines), voting 1);
    # a nonzero value must divide the world
    feature_shards: int = 0
    # the voting learner's vote: each data shard proposes its top_k owned
    # features by local split gain, and the histograms of at most
    # 2 * top_k voted features are summed over the data shards
    top_k: int = 20

    @property
    def compute_dtype(self) -> str:
        """The histogram mode: "float32", "bfloat16", "int8", or "int8_sr"
        for int8 with stochastic rounding (lightgbm_tpu/models/
        gbdt.py::_tuning_kwargs)."""
        if self.hist_dtype == "int8" and self.quant_rounding == "stochastic":
            return "int8_sr"
        return self.hist_dtype

    @property
    def policy(self) -> str:
        """The grower this configuration runs (models/grower_unified.py),
        resolved as lightgbm_tpu/models/gbdt.py::_serial_learner does."""
        if self.grow_policy == "depthwise":
            return "depthwise"
        return "leafwise" if self.leafwise_compact == "false" \
            else "leafcompact"

    def set(self, params: Dict[str, str]) -> None:
        self.min_data_in_leaf = _get_int(params, "min_data_in_leaf",
                                         self.min_data_in_leaf)
        self.min_sum_hessian_in_leaf = _get_float(
            params, "min_sum_hessian_in_leaf", self.min_sum_hessian_in_leaf)
        log.check(self.min_sum_hessian_in_leaf > 1.0
                  or self.min_data_in_leaf > 0,
                  "min_sum_hessian_in_leaf/min_data_in_leaf check failed")
        self.num_leaves = _get_int(params, "num_leaves", self.num_leaves)
        log.check(self.num_leaves > 1, "num_leaves should be > 1")
        self.feature_fraction_seed = _get_int(params, "feature_fraction_seed",
                                              self.feature_fraction_seed)
        self.feature_fraction = _get_float(params, "feature_fraction",
                                           self.feature_fraction)
        log.check(0.0 < self.feature_fraction <= 1.0,
                  "feature_fraction should be in (0, 1]")
        self.histogram_pool_size = _get_float(params, "histogram_pool_size",
                                              self.histogram_pool_size)
        self.max_depth = _get_int(params, "max_depth", self.max_depth)
        log.check(self.max_depth > 1 or self.max_depth < 0,
                  "max_depth should be > 1 or < 0")
        if "grow_policy" in params:
            value = params["grow_policy"].lower()
            log.check(value in ("leafwise", "depthwise"),
                      "grow_policy must be leafwise or depthwise")
            self.grow_policy = value
        self.hist_chunk = _get_int(params, "hist_chunk", self.hist_chunk)
        log.check(self.hist_chunk >= 0, "hist_chunk should be >= 0")
        self.leafwise_segments = _get_int(params, "leafwise_segments",
                                          self.leafwise_segments)
        log.check(self.leafwise_segments >= 1,
                  "leafwise_segments should be >= 1")
        if "dp_schedule" in params:
            value = params["dp_schedule"].lower()
            log.check(value in ("auto", "psum", "reduce_scatter"),
                      "dp_schedule must be auto, psum or reduce_scatter")
            self.dp_schedule = value
        if "leafwise_compact" in params:
            value = params["leafwise_compact"].lower()
            log.check(value in ("auto", "true", "false"),
                      "leafwise_compact must be auto, true or false")
            self.leafwise_compact = value
        if "hist_dtype" in params:
            value = params["hist_dtype"].lower()
            log.check(value in ("float32", "bfloat16", "int8"),
                      "hist_dtype must be float32, bfloat16 or int8")
            self.hist_dtype = value
        if "mixed_bin" in params:
            value = params["mixed_bin"].lower()
            log.check(value in ("auto", "true", "false"),
                      "mixed_bin must be auto, true or false")
            self.mixed_bin = value
        self.feature_shards = _get_int(params, "feature_shards",
                                       self.feature_shards)
        log.check(self.feature_shards >= 0,
                  "feature_shards should be >= 0")
        self.top_k = _get_int(params, "top_k", self.top_k)
        log.check(self.top_k >= 1, "top_k should be >= 1")
        if "quant_rounding" in params:
            value = params["quant_rounding"].lower()
            log.check(value in ("nearest", "stochastic"),
                      "quant_rounding must be nearest or stochastic")
            self.quant_rounding = value
            if value == "stochastic" and self.hist_dtype != "int8":
                log.warning("quant_rounding=stochastic only applies to "
                            "hist_dtype=int8; ignored for %s"
                            % self.hist_dtype)


@dataclasses.dataclass
class BoostingConfig:
    """lightgbm_tpu/config.py BoostingConfig (:699-845), slice subset."""
    output_freq: int = 1
    is_provide_training_metric: bool = False
    num_iterations: int = 10
    learning_rate: float = 0.1
    bagging_fraction: float = 1.0
    bagging_seed: int = 3
    bagging_freq: int = 0
    early_stopping_round: int = 0
    num_class: int = 1
    # where a bagging redraw runs: "auto" on the card with threefry
    # (ops/sampling.py) and on the CPU with numpy, as the JAX package
    # resolves it on an accelerator and on its CPU backend; "true" forces
    # the threefry draw wherever it applies (not per query), "false" the
    # numpy one
    bagging_device: str = "auto"
    goss: bool = False
    top_rate: float = 0.2
    other_rate: float = 0.1
    # checkpoints (checkpoint.py; lightgbm_tpu/config.py:762-778): every
    # checkpoint_interval iterations run_training hands a snapshot to a
    # background writer, plus one final checkpoint; 0 disables.  A
    # task=train restart with the same checkpoint_dir resumes from the
    # latest one.  checkpoint_keep (>= 1) finished files are kept
    checkpoint_interval: int = 0
    checkpoint_dir: str = ""
    checkpoint_keep: int = 2
    # the straggler drain (elastic.py; lightgbm_tpu/config.py:779-788):
    # elastic_shrink=true arms it under a parallel learner; a rank
    # strictly slowest straggler_k consecutive iteration boundaries is
    # flagged, the world checkpoints and every rank stops for a restart
    # of the survivors
    elastic_shrink: bool = False
    straggler_k: int = 3
    # training health (health.py; lightgbm_tpu/config.py:711-725): "auto"
    # on whenever telemetry is armed; the anomaly policy warn / halt /
    # record; k consecutive worsening eval iterations flag divergence
    # (0 off)
    health: str = "auto"
    on_anomaly: str = "warn"
    health_divergence_rounds: int = 0
    # pipelined boosting (lightgbm_tpu/config.py:726-738): auto, off or
    # readback, resolved by GBDT.pipeline_on as the JAX package resolves
    # it.  The JAX package's readback moves only host waits (trees,
    # scores and metrics are identical); the port's loop has no
    # iteration-level wait to defer yet, so every value trains
    # synchronously
    pipeline: str = "auto"
    # serial, data, feature, hybrid or voting (parallel/learners.py)
    tree_learner: str = "serial"
    tree_config: TreeConfig = dataclasses.field(default_factory=TreeConfig)

    def set(self, params: Dict[str, str]) -> None:
        self.num_iterations = _get_int(params, "num_iterations",
                                       self.num_iterations)
        log.check(self.num_iterations >= 0, "num_iterations should be >= 0")
        self.bagging_seed = _get_int(params, "bagging_seed",
                                     self.bagging_seed)
        self.bagging_freq = _get_int(params, "bagging_freq",
                                     self.bagging_freq)
        log.check(self.bagging_freq >= 0, "bagging_freq should be >= 0")
        self.bagging_fraction = _get_float(params, "bagging_fraction",
                                           self.bagging_fraction)
        log.check(0.0 < self.bagging_fraction <= 1.0,
                  "bagging_fraction should be in (0, 1]")
        self.learning_rate = _get_float(params, "learning_rate",
                                        self.learning_rate)
        log.check(self.learning_rate > 0.0, "learning_rate should be > 0")
        self.early_stopping_round = _get_int(params, "early_stopping_round",
                                             self.early_stopping_round)
        log.check(self.early_stopping_round >= 0,
                  "early_stopping_round should be >= 0")
        self.output_freq = _get_int(params, "metric_freq", self.output_freq)
        log.check(self.output_freq >= 0, "metric_freq should be >= 0")
        self.is_provide_training_metric = _get_bool(
            params, "is_training_metric", self.is_provide_training_metric)
        self.num_class = _get_num_class(params, self.num_class)
        # lightgbm_tpu/config.py:811-824
        if "health" in params:
            value = params["health"].lower()
            log.check(value in ("auto", "true", "false"),
                      "health must be auto, true or false")
            self.health = value
        if "on_anomaly" in params:
            value = params["on_anomaly"].lower()
            log.check(value in ("warn", "halt", "record"),
                      "on_anomaly must be warn, halt or record")
            self.on_anomaly = value
        self.health_divergence_rounds = _get_int(
            params, "health_divergence_rounds", self.health_divergence_rounds)
        log.check(self.health_divergence_rounds >= 0,
                  "health_divergence_rounds should be >= 0")
        # lightgbm_tpu/config.py:825-829
        if "pipeline" in params:
            value = params["pipeline"].lower()
            log.check(value in ("auto", "off", "readback"),
                      "pipeline must be auto, off or readback")
            self.pipeline = value
        if "tree_learner" in params:
            value = params["tree_learner"].lower()
            if value == "serial":
                self.tree_learner = "serial"
            elif value in ("feature", "feature_parallel"):
                self.tree_learner = "feature"
            elif value in ("data", "data_parallel"):
                self.tree_learner = "data"
            elif value == "hybrid":
                # rows sharded over the data shards, feature blocks owned
                # over the feature shards of one 2-D grid of ranks
                self.tree_learner = "hybrid"
            elif value in ("voting", "voting_parallel"):
                # the reference names voting but Fatals on it
                # (src/io/config.cpp:311-313); the JAX package realizes it
                # as top-k voting over the data shards (PV-tree)
                self.tree_learner = "voting"
            else:
                log.fatal("Tree learner type error")
        self.tree_config.set(params)
        if "bagging_device" in params:
            value = params["bagging_device"].lower()
            log.check(value in ("auto", "true", "false"),
                      "bagging_device must be auto, true or false")
            self.bagging_device = value
        self.goss = _get_bool(params, "goss", self.goss)
        self.top_rate = _get_float(params, "top_rate", self.top_rate)
        self.other_rate = _get_float(params, "other_rate", self.other_rate)
        if self.goss:
            log.check(0.0 <= self.top_rate < 1.0,
                      "top_rate should be in [0, 1)")
            log.check(0.0 < self.other_rate <= 1.0,
                      "other_rate should be in (0, 1]")
            log.check(self.top_rate + self.other_rate <= 1.0,
                      "top_rate + other_rate should be <= 1")
            if self.bagging_fraction < 1.0 and self.bagging_freq > 0:
                log.fatal("Cannot use bagging in GOSS mode "
                          "(goss=true with bagging_fraction < 1)")
        # lightgbm_tpu/config.py:848-861
        self.checkpoint_interval = _get_int(params, "checkpoint_interval",
                                            self.checkpoint_interval)
        log.check(self.checkpoint_interval >= 0,
                  "checkpoint_interval should be >= 0 (0 disables)")
        self.checkpoint_dir = params.get("checkpoint_dir",
                                         self.checkpoint_dir)
        if self.checkpoint_interval > 0 and not self.checkpoint_dir:
            log.fatal("checkpoint_interval > 0 requires checkpoint_dir "
                      "(where should the checkpoints go?)")
        self.checkpoint_keep = _get_int(params, "checkpoint_keep",
                                        self.checkpoint_keep)
        log.check(self.checkpoint_keep >= 1,
                  "checkpoint_keep should be >= 1 (the latest checkpoint "
                  "must survive)")
        self.elastic_shrink = _get_bool(params, "elastic_shrink",
                                        self.elastic_shrink)
        self.straggler_k = _get_int(params, "straggler_k", self.straggler_k)
        log.check(self.straggler_k >= 1, "straggler_k should be >= 1")


@dataclasses.dataclass
class NetworkConfig:
    """lightgbm_tpu/config.py NetworkConfig (:890-910), config.h:201-209:
    ``num_machines`` sets the parallel learners' world (parallel/
    mesh.world_size); the rest is checked and has no effect."""
    num_machines: int = 1
    local_listen_port: int = 12400
    time_out: int = 120
    machine_list_filename: str = ""

    def set(self, params: Dict[str, str]) -> None:
        self.num_machines = _get_int(params, "num_machines",
                                     self.num_machines)
        log.check(self.num_machines >= 1, "num_machines should be >= 1")
        self.local_listen_port = _get_int(params, "local_listen_port",
                                          self.local_listen_port)
        log.check(self.local_listen_port > 0,
                  "local_listen_port should be > 0")
        self.time_out = _get_int(params, "time_out", self.time_out)
        log.check(self.time_out > 0, "time_out should be > 0")
        self.machine_list_filename = params.get("machine_list_file",
                                                self.machine_list_filename)


@dataclasses.dataclass
class OverallConfig:
    task_type: str = "train"
    # the native parser's OpenMP pool (native/lib.set_num_threads); 0
    # leaves OpenMP's default
    num_threads: int = 0
    predict_leaf_index: bool = False
    objective_type: str = "regression"
    metric_types: List[str] = dataclasses.field(default_factory=list)
    # "cuda" (default: the card, or a Fatal without one) or "cpu" (the
    # kernels' plain versions; tests and reference runs)
    device: str = ""
    # the JAX package's device key, as given: "cpu" runs the plain
    # versions, "gpu" or "cuda" the card (DEVICE_TYPES); it sets
    # ``device`` and must agree with a ``device`` also given
    device_type: str = ""
    io_config: IOConfig = dataclasses.field(default_factory=IOConfig)
    boosting_config: BoostingConfig = dataclasses.field(
        default_factory=BoostingConfig)
    objective_config: ObjectiveConfig = dataclasses.field(
        default_factory=ObjectiveConfig)
    metric_config: MetricConfig = dataclasses.field(
        default_factory=MetricConfig)
    network_config: NetworkConfig = dataclasses.field(
        default_factory=NetworkConfig)
    # a parallel learner runs (num_machines > 1, tree_learner not serial)
    is_parallel: bool = False
    # ... and finds bins over the world's shards (tree_learner=data)
    is_parallel_find_bin: bool = False

    def set(self, params: Dict[str, str], require_data: bool = True) -> None:
        params = apply_aliases({k: str(v) for k, v in params.items()})
        check_slice(params)
        self.num_threads = _get_int(params, "num_threads", self.num_threads)
        if "task" in params:
            value = params["task"].lower()
            if value in ("train", "training"):
                self.task_type = "train"
            elif value in ("predict", "prediction", "test"):
                self.task_type = "predict"
            else:
                log.fatal("Task type error")
        self.predict_leaf_index = _get_bool(params, "predict_leaf_index",
                                            self.predict_leaf_index)
        if "objective" in params:
            self.objective_type = params["objective"].lower()
        if self.task_type == "train" \
                and self.objective_type not in OBJECTIVES:
            log.fatal("Parameter objective=%s is not supported by "
                      "lightgbm_tpu_torch (it trains %s)"
                      % (self.objective_type, ", ".join(OBJECTIVES)))
        if "metric" in params:
            seen = []
            for m in params["metric"].lower().split(","):
                m = m.strip()
                if m and m not in seen:
                    if m not in METRICS:
                        log.fatal("Parameter metric=%s is not supported by "
                                  "lightgbm_tpu_torch (it runs %s)"
                                  % (m, ", ".join(METRICS)))
                    seen.append(m)
            self.metric_types = seen
        self.device = params.get("device", self.device)
        self.device_type = params.get("device_type", self.device_type)
        self._resolve_device_type()
        self.io_config.set(params, require_data=require_data)
        self.boosting_config.set(params)
        self.objective_config.set(params)
        self.metric_config.set(params)
        self.network_config.set(params)
        self._check_param_conflict()
        log.set_level_from_verbosity(self.io_config.verbosity)

    def _resolve_device_type(self) -> None:
        """``device_type`` under the port's device rule (device.py):
        cpu -> the CPU, gpu or cuda -> the card; any other value (tpu
        included) and a ``device`` that names the other one are Fatal."""
        if not self.device_type:
            return
        want = DEVICE_TYPES.get(self.device_type.strip().lower())
        if want is None:
            log.fatal("Parameter device_type=%s is not supported by "
                      "lightgbm_tpu_torch (it runs cpu, gpu or cuda)"
                      % self.device_type)
        if self.device:
            have = self.device.strip().lower()
            if (have == "cpu") != (want == "cpu"):
                log.fatal("Parameters device=%s and device_type=%s "
                          "disagree" % (self.device, self.device_type))
        else:
            self.device = want

    def _check_param_conflict(self) -> None:
        """The objective, num_class and metric rules of
        lightgbm_tpu/config.py:972-985 (config.cpp:133-182)."""
        objective_multiclass = self.objective_type == "multiclass"
        num_class = self.boosting_config.num_class
        if objective_multiclass:
            if num_class <= 1:
                log.fatal("You should specify number of class(>=2) for "
                          "multiclass training.")
        elif self.task_type == "train" and num_class != 1:
            log.fatal("Number of class must be 1 for non-multiclass "
                      "training.")
        for metric_type in self.metric_types:
            if objective_multiclass != (metric_type in ("multi_logloss",
                                                        "multi_error")):
                log.fatal("Objective and metrics don't match.")
        # lightgbm_tpu/config.py:986-1018 (config.cpp:133-182)
        bc = self.boosting_config
        if self.network_config.num_machines <= 1:
            bc.tree_learner = "serial"
        self.is_parallel = bc.tree_learner != "serial"
        if not self.is_parallel:
            self.network_config.num_machines = 1
        # hybrid and voting shard rows over their data shards as data
        # does (lightgbm_tpu/config.py:1005-1016)
        self.is_parallel_find_bin = bc.tree_learner in ("data", "hybrid",
                                                        "voting")
        if bc.tree_learner in ("hybrid", "voting"):
            # a feature_shards that does not divide the world is refused
            # by the learner (parallel/mesh.factor_machines); refuse it
            # against num_machines here already
            from .parallel.mesh import factor_machines
            factor_machines(self.network_config.num_machines,
                            bc.tree_config.feature_shards,
                            voting=bc.tree_learner == "voting")
        if bc.elastic_shrink and not self.is_parallel:
            log.fatal("elastic_shrink=true requires a parallel "
                      "tree_learner and num_machines > 1 (there is no "
                      "mesh to shrink under serial training)")
        if (self.is_parallel_find_bin
                and bc.tree_config.histogram_pool_size >= 0):
            log.warning("Histogram LRU queue was enabled "
                        "(histogram_pool_size=%f). Will disable this for "
                        "reducing communication cost."
                        % bc.tree_config.histogram_pool_size)
            bc.tree_config.histogram_pool_size = -1


def parse_config_file(path: str) -> Dict[str, str]:
    """``key = value`` lines, ``#`` comments (application.cpp:78-113)."""
    params: Dict[str, str] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            key = key.strip().strip('"').strip("'")
            value = value.strip().strip('"').strip("'")
            if key:
                params[key] = value
    return params


def parse_argv(args: List[str]) -> Dict[str, str]:
    """CLI ``key=value`` tokens (application.cpp:59-76)."""
    params: Dict[str, str] = {}
    for arg in args:
        if "=" not in arg:
            log.warning("Unknown parameter %s" % arg)
            continue
        key, value = arg.split("=", 1)
        key = key.strip().strip('"').strip("'")
        value = value.strip().strip('"').strip("'")
        if key:
            params[key] = value
    return params


def load_config(argv: List[str]) -> OverallConfig:
    """argv pairs + optional config file; argv wins (application.cpp:98)."""
    cli_params = apply_aliases(parse_argv(argv))
    params: Dict[str, str] = {}
    if "config_file" in cli_params:
        params.update(parse_config_file(cli_params["config_file"]))
    params.update(cli_params)
    params.pop("config_file", None)
    config = OverallConfig()
    config.set(params)
    return config
