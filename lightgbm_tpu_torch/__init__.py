"""lightgbm_tpu_torch — the lightgbm_tpu GBDT ported to PyTorch and CUDA.

A second package beside the JAX reference ``lightgbm_tpu``; it imports
nothing of it.  The histogram and row-partition kernels are hand-written
CUDA for Hopper (csrc/), built with ``nvcc`` at first use; everything
else is plain torch.  Entry points run on the card (``device="cuda"``,
the default, raises without one) unless the caller passes
``device="cpu"``, which runs the kernels' plain versions.

- CLI: ``python -m lightgbm_tpu_torch task=train data=... [device=cpu]``
- Python: :class:`Dataset`, :func:`train`, :class:`GBDT`.
"""
from __future__ import annotations

from .config import OverallConfig
from .io.dataset import Dataset
from .models.gbdt import GBDT
from .models.tree import Tree

__version__ = "0.1.0"


def train(params: dict, train_set: Dataset, valid_sets=(), valid_names=None,
          device=None, progress_fn=None) -> GBDT:
    """Train a booster (lightgbm_tpu.train's counterpart).  ``device``:
    explicit argument, else ``params["device"]``, else "cuda".
    ``progress_fn(iteration)`` runs after every boosting iteration."""
    from .metrics import create_metrics
    from .objectives import create_objective

    config = OverallConfig()
    config.set({k: str(v) for k, v in params.items()}, require_data=False)
    device = device or config.device or None
    bc = config.boosting_config
    booster = GBDT()
    train_metrics = []
    if bc.is_provide_training_metric:
        train_metrics = create_metrics(config)
    booster.init(bc, train_set,
                 create_objective(config.objective_type,
                                  config.objective_config),
                 train_metrics, device=device)
    for i, valid in enumerate(valid_sets):
        name = valid_names[i] if valid_names else "valid_%d" % (i + 1)
        booster.add_valid_dataset(valid, create_metrics(config), name=name)
    is_eval = bool(train_metrics) or bool(valid_sets)
    booster.run_training(bc.num_iterations, is_eval,
                         progress_fn=progress_fn)
    return booster


__all__ = ["Dataset", "GBDT", "OverallConfig", "Tree", "train"]
