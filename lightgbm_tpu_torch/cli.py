"""The command line: ``python -m lightgbm_tpu_torch key=value ...``.

Counterpart of lightgbm_tpu/cli.py for ``task=train`` and
``task=predict`` (application.cpp:28-302).  It runs on the card unless
the command line says ``device=cpu``.
"""
from __future__ import annotations

import sys
import time
from typing import List

from . import config as config_mod
from .io.dataset import Dataset
from .metrics import create_metrics
from .models.gbdt import GBDT
from .models.predictor import Predictor
from .objectives import create_objective
from .utils import log


class Application:
    def __init__(self, argv: List[str]):
        self.config = config_mod.load_config(argv)

    def run(self) -> None:
        if self.config.task_type == "train":
            self.train()
        else:
            self.predict()

    def train(self) -> None:
        """Application::InitTrain + Train (application.cpp:201-257)."""
        cfg = self.config
        io = cfg.io_config
        start = time.perf_counter()
        train_data = Dataset.load_train(io)
        train_metrics = (create_metrics(cfg)
                         if cfg.boosting_config.is_provide_training_metric
                         else [])
        booster = GBDT()
        booster.init(cfg.boosting_config, train_data,
                     create_objective(cfg.objective_type,
                                      cfg.objective_config),
                     train_metrics, device=cfg.device or None)
        for filename in io.valid_data_filenames:
            booster.add_valid_dataset(
                Dataset.load_valid(train_data, filename, io.has_header),
                create_metrics(cfg), name=filename)
        log.info("Finish loading data, use %f seconds"
                 % (time.perf_counter() - start))
        log.info("Start train ...")
        is_eval = bool(train_metrics) or any(booster.valid_metrics)
        start = time.perf_counter()
        booster.run_training(
            cfg.boosting_config.num_iterations, is_eval,
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
        Predictor(booster, io.is_sigmoid, io.num_model_predict).predict_file(
            io.data_filename, io.output_result, io.has_header)
        log.info("Finished prediction")


def main(argv: List[str] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    try:
        Application(argv).run()
    except log.LightGBMError:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
