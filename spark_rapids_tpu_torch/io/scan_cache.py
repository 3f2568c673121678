"""Device scan cache: uploaded scan batches kept on the device across
queries.

Counterpart of ``spark_rapids_tpu/io/scan_cache.py``.  A file scan's
batches are keyed on the files (path, size, modification time), the
columns read, the pushed filters, the batch size and the device; a warm
query reuses them, so its wall time measures the device path and a cold
one the read and the upload.  The cache holds at most ``max_bytes`` of
device memory, least recently used first out, and ``clear()`` empties
it.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

#: default device bytes the cache may hold
DEFAULT_MAX_BYTES = 24 << 30


def batch_bytes(batch) -> int:
    n = 0
    for c in batch.columns:
        n += c.data.numel() * c.data.element_size()
        n += c.validity.numel()
        offsets = getattr(c, "offsets", None)
        if offsets is not None:
            n += offsets.numel() * offsets.element_size()
    return n


class DeviceScanCache:
    _instance: Optional["DeviceScanCache"] = None
    _lock = threading.Lock()

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self._store: "OrderedDict[tuple, Tuple[list, int]]" = OrderedDict()
        self.max_bytes = max_bytes
        self.bytes = 0

    @classmethod
    def get(cls) -> "DeviceScanCache":
        with cls._lock:
            if cls._instance is None:
                cls._instance = DeviceScanCache()
            return cls._instance

    def lookup(self, key: tuple) -> Optional[List[list]]:
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                return None
            self._store.move_to_end(key)
            return hit[0]

    def insert(self, key: tuple, parts: List[list]) -> None:
        """Keep ``parts`` unless they alone exceed the budget; evict the
        least recently used entries past it."""
        nbytes = sum(batch_bytes(b) for part in parts for b in part)
        if nbytes > self.max_bytes:
            return
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._store[key] = (parts, nbytes)
            self.bytes += nbytes
            while self.bytes > self.max_bytes:
                _, (_, nb) = self._store.popitem(last=False)
                self.bytes -= nb

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.bytes = 0
