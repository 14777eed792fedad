"""Fused k-token paged append+attend (CUDA kernel + plain version)."""
