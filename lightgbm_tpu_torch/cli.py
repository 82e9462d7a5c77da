"""The command line: ``python -m lightgbm_tpu_torch key=value ...``.

Counterpart of lightgbm_tpu/cli.py for ``task=train`` and
``task=predict`` (application.cpp:28-302).  It runs on the card unless
the command line says ``device=cpu``.  ``num_threads`` caps the native
parser's OpenMP pool; the training and validation loads take the
command line's ingest keys (columns, header, caches, streaming), and a
load with ``is_save_binary_file`` writes the cache (in a world, rank 0
alone writes the whole table's).  A ``checkpoint_dir``
that holds a checkpoint resumes training from the latest one, and the
run trains what is left of ``num_iterations``; ``elastic_shrink`` arms
the straggler drain.  The observability keys
arm the session as lightgbm_tpu/cli.py:263-310 does
(``telemetry.arm_session``): the ``metrics_out`` sink with the flight
recorder, the live monitor, the stall watchdog; ``profile_dir`` wraps
the training loop in ``torch.profiler``; ``main`` ends the session.

A parallel learner (``tree_learner=data|feature|hybrid|voting`` with
``num_machines > 1``) runs one rank a process, launched by ``python -m
torch.distributed.run --nproc-per-node P -m lightgbm_tpu_torch
config=...``: each rank joins the world, takes the world's smallest
``data_random_seed``, ``feature_fraction_seed`` and ``feature_fraction``
(lightgbm_tpu/cli.py:324-337), loads its shard under ``data``, its data
index's shard under ``hybrid`` and ``voting`` (each with the distributed
bin finder; ``learners.row_shard``) or every row under ``feature``, by
any load route, and trains the same trees.  Once the world has formed, ``timeline=``
resolves and the flight recorder takes the rank's identity
(``telemetry.resolve_world``); the sink opens at the first record, so
only rank 0 writes ``metrics_out``, or every rank its own shard.  Rank 0
writes ``output_model``; rank r > 0 writes the same text to
``<output_model>.rank<r>``.  Every rank resumes from the
world's checkpoint (``GBDT.resume_latest``), whatever the world that
wrote it.  ``main`` leaves the world on success and on a ``Fatal``
alike.
"""
from __future__ import annotations

import sys
import time
from typing import List

from . import config as config_mod
from . import telemetry
from .io.dataset import Dataset
from .metrics import create_metrics
from .models.gbdt import GBDT
from .models.predictor import Predictor, continuation_score
from .native import lib as native_lib
from .objectives import create_objective
from .parallel import learners, mesh
from .serving import engine_options_from_config
from .utils import log


class Application:
    def __init__(self, argv: List[str]):
        self.config = config_mod.load_config(argv)
        if self.config.num_threads > 0:
            native_lib.set_num_threads(self.config.num_threads)
        telemetry.arm_session(self.config.io_config)

    def run(self) -> None:
        if self.config.task_type == "train":
            self.train()
        else:
            self.predict()

    def train(self) -> None:
        """Application::InitTrain + Train (application.cpp:201-257).  With
        ``input_model``, training continues that model
        (lightgbm_tpu/cli.py:353-362): its trees stay the booster's first
        models, and every training and validation row starts from its
        score under them."""
        cfg = self.config
        io = cfg.io_config
        start = time.perf_counter()
        learner = init_parallel(cfg)
        rank, shards = learners.row_shard(cfg)
        bin_finder = (learners.distributed_bin_finder()
                      if cfg.is_parallel_find_bin else None)
        booster = GBDT()
        predict_fun = None
        if io.input_model:
            cont = GBDT.from_model_file(io.input_model,
                                        device=cfg.device or None)
            predict_fun = lambda feats: continuation_score(  # noqa: E731
                cont.models, feats, cont.device)
            booster.models = cont.models
        train_data = Dataset.load_train(io, predict_fun,
                                        device=cfg.device or None,
                                        rank=rank, num_machines=shards,
                                        bin_finder=bin_finder)
        train_metrics = (create_metrics(cfg)
                         if cfg.boosting_config.is_provide_training_metric
                         else [])
        booster.init(cfg.boosting_config, train_data,
                     create_objective(cfg.objective_type,
                                      cfg.objective_config),
                     train_metrics, device=cfg.device or None,
                     learner=learner)
        for filename in io.valid_data_filenames:
            booster.add_valid_dataset(
                Dataset.load_valid(train_data, filename, predict_fun,
                                   io_config=io),
                create_metrics(cfg), name=filename)
        log.info("Finish loading data, use %f seconds"
                 % (time.perf_counter() - start))
        # a checkpoint to resume (with input_model too: a Fatal, the two
        # are mutually exclusive), every rank of a world alike
        booster.resume_latest(cfg.boosting_config.checkpoint_dir)
        arm_elastic(cfg, booster)
        log.info("Start train ...")
        is_eval = bool(train_metrics) or any(booster.valid_metrics)
        start = time.perf_counter()
        rank = mesh.get_rank()
        output = io.output_model + ("" if rank == 0 else ".rank%d" % rank)
        with telemetry.profile(io.profile_dir):
            booster.run_training(
                booster.remaining_iterations(
                    cfg.boosting_config.num_iterations),
                is_eval,
                save_fn=lambda: booster.save_model_to_file(False, output),
                progress_fn=lambda it: log.info(
                    "%f seconds elapsed, finished %d iteration"
                    % (time.perf_counter() - start, it)))
        booster.save_model_to_file(True, output)
        log.info("Finished train")

    def predict(self) -> None:
        io = self.config.io_config
        if not io.input_model:
            log.fatal("Please provide a model file for prediction")
        booster = GBDT.from_model_file(io.input_model,
                                       device=self.config.device or None)
        Predictor(booster, io.is_sigmoid, self.config.predict_leaf_index,
                  io.num_model_predict,
                  serving_options=engine_options_from_config(io)
                  ).predict_file(io.data_filename, io.output_result,
                                 io.has_header)
        if telemetry.enabled():
            # no training loop writes the totals here: the serve/* family
            # reaches the sink through this summary
            telemetry.emit_summary()
        log.info("Finished prediction")


def init_parallel(cfg):
    """Application::InitTrain's parallel part (lightgbm_tpu/cli.py:
    324-351): join the world, take the world's smallest seeds and
    feature fraction, make the learner, and settle the timeline mode and
    the rank identity of what the session records
    (``telemetry.resolve_world``); None for the serial learner."""
    if not cfg.is_parallel:
        return None
    mesh.init_distributed()
    io, tree = cfg.io_config, cfg.boosting_config.tree_config
    io.data_random_seed = mesh.sync_up_by_min(io.data_random_seed)
    tree.feature_fraction_seed = mesh.sync_up_by_min(
        tree.feature_fraction_seed)
    tree.feature_fraction = mesh.sync_up_by_min(tree.feature_fraction)
    learner = learners.create_parallel_learner(cfg)
    telemetry.resolve_world(io)
    return learner


def arm_elastic(cfg, booster) -> None:
    """The straggler drain under ``elastic_shrink`` and a parallel
    learner (lightgbm_tpu/cli.py:382-402).  The survivors' restart is a
    new world: its learner factors the grid over the ranks it has
    (``num_machines`` past the world shrinks to it)."""
    if cfg.boosting_config.elastic_shrink and cfg.is_parallel:
        booster.enable_elastic()


def main(argv: List[str] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        Application(argv).run()
    except log.LightGBMError:
        return 1
    finally:
        # closes the sink, the recorder (with its dump) and the monitor;
        # then leaves the world, if this run joined one
        telemetry.disable()
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
