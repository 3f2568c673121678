"""Device scan cache: uploaded scan batches kept on the device across
queries.

Counterpart of ``spark_rapids_tpu/io/scan_cache.py``.  A file scan's
batches are keyed on the files (path, size, modification time), the
columns read, the pushed filters, the batch size and the device; a warm
query reuses them, so its wall time measures the device path and a cold
one the read and the upload.  The cache holds at most the bytes its
caller allows (``io.deviceScanCache.bytes``), least recently used first
out; ``clear()`` empties it, and a device OOM empties it first
(``clear_on_pressure``, ``memory/pressure.oom_retry``): every entry can
be read again from its files.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple



class DeviceScanCache:
    _instance: Optional["DeviceScanCache"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._store: "OrderedDict[tuple, Tuple[list, int]]" = OrderedDict()
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

    def insert(self, key: tuple, parts: List[list], nbytes: int,
               cap_bytes: int) -> None:
        """Keep ``parts`` (``nbytes`` on the device) unless they alone
        exceed ``cap_bytes``; evict the least recently used entries past
        it."""
        if nbytes > cap_bytes:
            return
        with self._lock:
            old = self._store.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._store[key] = (parts, nbytes)
            self.bytes += nbytes
            while self.bytes > cap_bytes:
                _, (_, nb) = self._store.popitem(last=False)
                self.bytes -= nb

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.bytes = 0


def clear_on_pressure() -> int:
    """Drop every cached scan (the device-OOM hook); returns the device
    bytes the cache held."""
    cache = DeviceScanCache._instance
    if cache is None:
        return 0
    held = cache.bytes
    cache.clear()
    return held
