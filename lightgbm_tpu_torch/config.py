"""Configuration: the subset of lightgbm_tpu/config.py this slice runs.

Same parameter names, aliases (lightgbm_tpu/config.py:26-84) and defaults
for the keys the binary ``task=train`` / ``task=predict`` example uses.
The difference is the slice rule: a key the port does not run raises
``Fatal`` naming it, instead of being parsed and silently ignored.  Keys
whose JAX-package default is the only value the slice runs (serial
learner, leaf-wise compacted growth, no sampling) are accepted at that
value and refused at any other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from .utils import log

# lightgbm_tpu/config.py:26-84, restricted to the keys of this slice
ALIAS_TABLE: Dict[str, str] = {
    "config": "config_file",
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
    "predict_result": "output_result",
    "prediction_result": "output_result",
    "valid": "valid_data",
    "test_data": "valid_data",
    "test": "valid_data",
    "tranining_metric": "is_training_metric",
    "train_metric": "is_training_metric",
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
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "verbosity": "verbose",
    "header": "has_header",
}

# keys this slice runs at any valid value
SLICE_KEYS = frozenset((
    "config_file", "task", "data", "valid_data", "input_model",
    "output_model", "output_result", "objective", "metric",
    "num_iterations", "learning_rate", "num_leaves", "max_depth",
    "min_data_in_leaf", "min_sum_hessian_in_leaf", "max_bin", "sigmoid",
    "is_unbalance", "hist_dtype", "quant_rounding", "device",
    "data_random_seed", "verbose", "metric_freq", "is_training_metric",
    "has_header", "is_sigmoid", "num_model_predict",
))

# keys of the JAX package whose default is the only value the slice runs
DEFAULT_ONLY = {
    "boosting_type": ("gbdt", "gbrt"),
    "tree_learner": ("serial",),
    "num_machines": ("1",),
    "num_class": ("1",),
    "grow_policy": ("leafwise",),
    "leafwise_compact": ("auto", "true"),
    "mixed_bin": ("auto", "false"),
    "bagging_fraction": ("1", "1.0"),
    "bagging_freq": ("0",),
    "feature_fraction": ("1", "1.0"),
    "goss": ("false", "-"),
    "early_stopping_round": ("0",),
    "streaming": ("false",),
    "checkpoint_interval": ("0",),
    "predict_leaf_index": ("false", "-"),
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
    verbosity: int = 1
    has_header: bool = False
    is_sigmoid: bool = True
    num_model_predict: int = -1

    def set(self, params: Dict[str, str], require_data: bool = True) -> None:
        self.max_bin = _get_int(params, "max_bin", self.max_bin)
        log.check(0 < self.max_bin <= 256,
                  "max_bin should be in (0, 256] (uint8 bin matrix)")
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
        self.verbosity = _get_int(params, "verbose", self.verbosity)
        self.has_header = _get_bool(params, "has_header", self.has_header)
        self.is_sigmoid = _get_bool(params, "is_sigmoid", self.is_sigmoid)
        self.num_model_predict = _get_int(params, "num_model_predict",
                                          self.num_model_predict)


@dataclasses.dataclass
class ObjectiveConfig:
    sigmoid: float = 1.0
    is_unbalance: bool = False

    def set(self, params: Dict[str, str]) -> None:
        self.is_unbalance = _get_bool(params, "is_unbalance",
                                      self.is_unbalance)
        self.sigmoid = _get_float(params, "sigmoid", self.sigmoid)


@dataclasses.dataclass
class MetricConfig:
    sigmoid: float = 1.0

    def set(self, params: Dict[str, str]) -> None:
        self.sigmoid = _get_float(params, "sigmoid", self.sigmoid)


@dataclasses.dataclass
class TreeConfig:
    """lightgbm_tpu/config.py TreeConfig (:537-696), slice subset."""
    min_data_in_leaf: int = 100
    min_sum_hessian_in_leaf: float = 10.0
    num_leaves: int = 127
    max_depth: int = -1
    hist_dtype: str = "float32"
    quant_rounding: str = "nearest"

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
        self.max_depth = _get_int(params, "max_depth", self.max_depth)
        log.check(self.max_depth > 1 or self.max_depth < 0,
                  "max_depth should be > 1 or < 0")
        if "hist_dtype" in params:
            value = params["hist_dtype"].lower()
            if value not in ("float32", "int8"):
                log.fatal("Parameter hist_dtype=%s is not supported by "
                          "lightgbm_tpu_torch (the ported slice runs "
                          "float32/int8)" % value)
            self.hist_dtype = value
        if "quant_rounding" in params:
            value = params["quant_rounding"].lower()
            if value != "nearest":
                log.fatal("Parameter quant_rounding=%s is not supported by "
                          "lightgbm_tpu_torch (the ported slice runs "
                          "nearest)" % value)
            self.quant_rounding = value


@dataclasses.dataclass
class BoostingConfig:
    output_freq: int = 1
    is_provide_training_metric: bool = False
    num_iterations: int = 10
    learning_rate: float = 0.1
    tree_config: TreeConfig = dataclasses.field(default_factory=TreeConfig)

    def set(self, params: Dict[str, str]) -> None:
        self.num_iterations = _get_int(params, "num_iterations",
                                       self.num_iterations)
        log.check(self.num_iterations >= 0, "num_iterations should be >= 0")
        self.learning_rate = _get_float(params, "learning_rate",
                                        self.learning_rate)
        log.check(self.learning_rate > 0.0, "learning_rate should be > 0")
        self.output_freq = _get_int(params, "metric_freq", self.output_freq)
        log.check(self.output_freq >= 0, "metric_freq should be >= 0")
        self.is_provide_training_metric = _get_bool(
            params, "is_training_metric", self.is_provide_training_metric)
        self.tree_config.set(params)


@dataclasses.dataclass
class OverallConfig:
    task_type: str = "train"
    objective_type: str = "regression"
    metric_types: List[str] = dataclasses.field(default_factory=list)
    # "cuda" (default: the card, or a Fatal without one) or "cpu" (the
    # kernels' plain versions; tests and reference runs)
    device: str = ""
    io_config: IOConfig = dataclasses.field(default_factory=IOConfig)
    boosting_config: BoostingConfig = dataclasses.field(
        default_factory=BoostingConfig)
    objective_config: ObjectiveConfig = dataclasses.field(
        default_factory=ObjectiveConfig)
    metric_config: MetricConfig = dataclasses.field(
        default_factory=MetricConfig)

    def set(self, params: Dict[str, str], require_data: bool = True) -> None:
        params = apply_aliases({k: str(v) for k, v in params.items()})
        check_slice(params)
        if "task" in params:
            value = params["task"].lower()
            if value in ("train", "training"):
                self.task_type = "train"
            elif value in ("predict", "prediction", "test"):
                self.task_type = "predict"
            else:
                log.fatal("Task type error")
        if "objective" in params:
            self.objective_type = params["objective"].lower()
        if self.task_type == "train" and self.objective_type != "binary":
            log.fatal("Parameter objective=%s is not supported by "
                      "lightgbm_tpu_torch (the ported slice trains "
                      "objective=binary)" % self.objective_type)
        if "metric" in params:
            seen = []
            for m in params["metric"].lower().split(","):
                m = m.strip()
                if m and m not in seen:
                    if m not in ("binary_logloss", "auc"):
                        log.fatal("Parameter metric=%s is not supported by "
                                  "lightgbm_tpu_torch (the ported slice "
                                  "runs binary_logloss, auc)" % m)
                    seen.append(m)
            self.metric_types = seen
        self.device = params.get("device", self.device)
        self.io_config.set(params, require_data=require_data)
        self.boosting_config.set(params)
        self.objective_config.set(params)
        self.metric_config.set(params)
        log.set_level_from_verbosity(self.io_config.verbosity)


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
