"""lightgbm_tpu_torch — the lightgbm_tpu GBDT ported to PyTorch and CUDA.

A second package beside the JAX reference ``lightgbm_tpu``; it imports
nothing of it.  The histogram and row-partition kernels are hand-written
CUDA for Hopper (csrc/), built with ``nvcc`` at first use; everything
else is plain torch.  Entry points run on the card (``device="cuda"``,
the default, raises without one) unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.

- CLI: ``python -m lightgbm_tpu_torch task=train data=... [device=cpu]``
  (``task=predict`` scores through the serving engine)
- Python: :class:`Dataset` (``Dataset.load_train(io_config)`` loads a
  text file or a dataset cache, ``from_arrays`` arrays), :func:`train`
  (with ``tree_learner=data|feature`` on every rank of a
  ``torch.distributed`` world: ``parallel``),
  :class:`GBDT`; serving: :class:`FlatEnsemble`, :class:`ServingEngine`,
  :class:`ServingFront` (``serving``, or ``GBDT.serving_engine``);
  checkpoints: ``checkpoint`` (the file format, the background writer)
  and ``faults`` (a one-shot kill, raise or stall at an iteration
  boundary, for tests); ``elastic`` (the straggler rule of the drain);
  observability: ``telemetry`` (spans, counters,
  the JSONL sink, memory gauges, the stall watchdog), ``tracing`` (the
  flight recorder), ``health``, ``costmodel`` (the kernel roofline),
  ``monitor`` (windows, SLO burn, score drift), ``podtrace`` (a world's
  dumps on one clock).

An exec'd parse worker of io/parallel_ingest.py (``WORKER_ENV`` there
set to 1) imports only the numpy parse stack: the package skips torch.
"""
from __future__ import annotations

import os as _os

__version__ = "0.1.0"

if _os.environ.get("LIGHTGBM_TPU_TORCH_INGEST_WORKER") != "1":
    from .config import OverallConfig
    from .io.dataset import Dataset
    from .models.gbdt import GBDT
    from .models.tree import Tree
    from . import checkpoint, elastic, faults, serving, telemetry
    from .serving import FlatEnsemble, ServingEngine, ServingFront


def train(params: dict, train_set: Dataset, valid_sets=(), valid_names=None,
          device=None, progress_fn=None) -> GBDT:
    """Train a booster (lightgbm_tpu.train's counterpart).  ``device``:
    explicit argument, else ``params["device"]``, else "cuda".
    ``progress_fn(iteration)`` runs after every boosting iteration.  With
    ``early_stopping_round`` in ``params``, the metrics of ``valid_sets``
    stop the run and the last ``early_stopping_round`` iterations' trees
    are dropped; a dataset whose metadata carries ``init_score`` starts
    from it (tiled over the classes).  The checkpoint keys act as on the
    command line: ``checkpoint_interval`` writes checkpoints into
    ``checkpoint_dir``, and a ``checkpoint_dir`` that holds one resumes
    from the latest and trains what is left of ``num_iterations``.  The
    observability keys arm the session as on the command line
    (``telemetry.arm_session``), and a session this call armed ends with
    it (lightgbm_tpu/__init__.py:48-103); ``profile_dir`` wraps the
    training loop in ``torch.profiler``.  In a world, rank 0 alone writes
    ``metrics_out``, or each rank its own shard under ``timeline=``
    (``telemetry.resolve_world``, once the world has formed).  ``elastic_shrink`` arms the
    straggler drain under a parallel learner.

    A parallel learner (``tree_learner`` data, feature, hybrid or voting,
    ``num_machines > 1``): every rank of the world calls ``train`` with
    its own ``train_set`` (under data its shard, e.g.
    ``Dataset.load_train(io, rank=..., num_machines=..., bin_finder=
    parallel.distributed_bin_finder())``; under hybrid and voting the
    shard of its data index, ``rank, num_machines =
    parallel.learners.row_shard(config)``; under feature every row).  The world is
    torch's environment's (``parallel.init_distributed``, which ``train``
    calls and which the caller may call first), or one rank without
    one; the process group stays for the caller (``parallel.shutdown``
    leaves it)."""
    from .cli import arm_elastic, init_parallel
    from .metrics import create_metrics
    from .objectives import create_objective

    config = OverallConfig()
    config.set({k: str(v) for k, v in params.items()}, require_data=False)
    device = device or config.device or None
    bc = config.boosting_config
    armed = telemetry.arm_session(config.io_config)
    try:
        learner = init_parallel(config)
        booster = GBDT()
        train_metrics = []
        if bc.is_provide_training_metric:
            train_metrics = create_metrics(config)
        booster.init(bc, train_set,
                     create_objective(config.objective_type,
                                      config.objective_config),
                     train_metrics, device=device, learner=learner)
        for i, valid in enumerate(valid_sets):
            name = valid_names[i] if valid_names else "valid_%d" % (i + 1)
            booster.add_valid_dataset(valid, create_metrics(config),
                                      name=name)
        booster.resume_latest(bc.checkpoint_dir)
        arm_elastic(config, booster)
        is_eval = bool(train_metrics) or bool(valid_sets)
        with telemetry.profile(config.io_config.profile_dir):
            booster.run_training(
                booster.remaining_iterations(bc.num_iterations), is_eval,
                progress_fn=progress_fn)
    finally:
        if armed:
            # a later train() without the keys must not append records;
            # snapshot() still serves the data after disable
            telemetry.disable()
    return booster


__all__ = ["Dataset", "FlatEnsemble", "GBDT", "OverallConfig",
           "ServingEngine", "ServingFront", "Tree", "checkpoint", "elastic",
           "faults", "serving", "telemetry", "train"]
