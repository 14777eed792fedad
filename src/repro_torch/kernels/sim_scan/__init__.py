"""The simulator's access loop in one launch (CUDA kernel + plain version)."""
