"""Synthetic data generators and the out-of-core row stores."""
from .store import (ArrayStore, ArrayStoreWriter, MemoryStore, PartitionedStore, as_store,
                    is_store, partition_bounds)

__all__ = ["ArrayStore", "ArrayStoreWriter", "MemoryStore", "PartitionedStore", "as_store",
           "is_store", "partition_bounds"]
