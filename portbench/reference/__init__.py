"""Plain float64 PyTorch reference of what the port computes."""
