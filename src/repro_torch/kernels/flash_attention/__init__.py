"""GQA causal / sliding-window / full prefill attention (CUDA kernel +
plain version)."""
