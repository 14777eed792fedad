"""Two-level iRT walk (CUDA kernel + plain version)."""
