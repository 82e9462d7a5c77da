"""The command line: ``python -m lightgbm_tpu_torch key=value ...``.

Counterpart of lightgbm_tpu/cli.py for ``task=train`` and
``task=predict`` (application.cpp:28-302).  It runs on the card unless
the command line says ``device=cpu``.  ``num_threads`` caps the native
parser's OpenMP pool; the training and validation loads take the
command line's ingest keys (columns, header, caches, streaming), and a
load with ``is_save_binary_file`` writes the cache.  A ``checkpoint_dir``
that holds a checkpoint resumes training from the latest one, and the
run trains what is left of ``num_iterations``.  The observability keys
arm the session as lightgbm_tpu/cli.py:263-310 does
(``telemetry.arm_session``): the ``metrics_out`` sink with the flight
recorder, the live monitor, the stall watchdog; ``profile_dir`` wraps
the training loop in ``torch.profiler``; ``main`` ends the session.
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
        booster = GBDT()
        predict_fun = None
        if io.input_model:
            cont = GBDT.from_model_file(io.input_model,
                                        device=cfg.device or None)
            predict_fun = lambda feats: continuation_score(  # noqa: E731
                cont.models, feats, cont.device)
            booster.models = cont.models
        train_data = Dataset.load_train(io, predict_fun,
                                        device=cfg.device or None)
        train_metrics = (create_metrics(cfg)
                         if cfg.boosting_config.is_provide_training_metric
                         else [])
        booster.init(cfg.boosting_config, train_data,
                     create_objective(cfg.objective_type,
                                      cfg.objective_config),
                     train_metrics, device=cfg.device or None)
        for filename in io.valid_data_filenames:
            booster.add_valid_dataset(
                Dataset.load_valid(train_data, filename, predict_fun,
                                   io_config=io),
                create_metrics(cfg), name=filename)
        log.info("Finish loading data, use %f seconds"
                 % (time.perf_counter() - start))
        # a checkpoint to resume (with input_model too: a Fatal, the two
        # are mutually exclusive)
        booster.resume_latest(cfg.boosting_config.checkpoint_dir)
        log.info("Start train ...")
        is_eval = bool(train_metrics) or any(booster.valid_metrics)
        start = time.perf_counter()
        with telemetry.profile(io.profile_dir):
            booster.run_training(
                booster.remaining_iterations(
                    cfg.boosting_config.num_iterations),
                is_eval,
                save_fn=lambda: booster.save_model_to_file(False,
                                                           io.output_model),
                progress_fn=lambda it: log.info(
                    "%f seconds elapsed, finished %d iteration"
                    % (time.perf_counter() - start, it)))
        booster.save_model_to_file(True, io.output_model)
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


def main(argv: List[str] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        Application(argv).run()
    except log.LightGBMError:
        return 1
    finally:
        # closes the sink, the recorder (with its dump) and the monitor
        telemetry.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())
