"""Hand-written Hopper kernels, each behind a ``kernels/<name>/ops.py``
wrapper with a plain PyTorch version in ``ref.py``."""
