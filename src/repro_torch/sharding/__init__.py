from .rules import (
    batch_spec, cache_specs, device_bytes, dp_axes, fsdp_axes, param_specs, shard_count, tp_size,
)

__all__ = ["batch_spec", "cache_specs", "device_bytes", "dp_axes", "fsdp_axes", "param_specs",
           "shard_count", "tp_size"]
