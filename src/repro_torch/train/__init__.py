"""Training (port of ``repro.train``): AdamW, int8 error-feedback
compression and the training loop with checkpoints and preemption."""
