"""Migration page gather (CUDA kernel + plain version)."""
