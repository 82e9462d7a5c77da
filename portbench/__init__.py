"""The benchmark of lightgbm_tpu_torch on NVIDIA H100s (README.md)."""
