from .dataset import Dataset

__all__ = ["Dataset"]
