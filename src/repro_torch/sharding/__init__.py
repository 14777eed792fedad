"""Sharding (port of ``repro.sharding``): logical-axis specs laid out as
DTensors on a ``torch.distributed`` ``DeviceMesh``."""
