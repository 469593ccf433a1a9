"""Multi-device parallelism: per-device shards + the min cascade."""

from .mesh import default_devices, resolve_devices
from .sweep import sweep_min_hash_sharded

__all__ = ["default_devices", "resolve_devices", "sweep_min_hash_sharded"]
