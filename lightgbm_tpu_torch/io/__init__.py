import os as _os

if _os.environ.get("LIGHTGBM_TPU_TORCH_INGEST_WORKER") != "1":
    # an exec'd parse worker (parallel_ingest.py) skips Dataset, which
    # imports torch
    from .dataset import Dataset

__all__ = ["Dataset"]
