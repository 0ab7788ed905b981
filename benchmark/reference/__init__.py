"""Plain PyTorch reference of the benchmark's correctness check."""
