"""repro_torch: the PyTorch/CUDA port of the Trimma tiered-KV serving
system (the JAX package ``repro`` is the reference it is tested against).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises
(``repro_torch.device.resolve_device``).  The port never imports JAX or
the reference package.
"""
