"""Spillable batch handles.

Counterpart of ``spark_rapids_tpu/memory/spillable.py`` (the reference's
``SpillableColumnarBatch``).  An operator registers a batch with the
catalog and keeps only this handle; the catalog may move the batch down
the tiers while the handle lives, and ``materialize()`` brings it back.
"""
from __future__ import annotations

from typing import Optional

from .catalog import (ACTIVE_BATCH_PRIORITY, BufferCatalog, StorageTier)


class SpillableBatch:
    def __init__(self, batch, priority: int = ACTIVE_BATCH_PRIORITY,
                 catalog: Optional[BufferCatalog] = None):
        self.catalog = catalog or BufferCatalog.get()
        self.nbytes = batch.nbytes()
        self.num_rows = batch.num_rows
        self.buffer_id = self.catalog.register(batch, self.nbytes, priority)
        self._closed = False

    def materialize(self):
        """The batch on the device (may unspill), pinned there until
        ``release()`` or ``close()``."""
        assert not self._closed, "use after close"
        return self.catalog.acquire(self.buffer_id, pin=True)

    def release(self) -> None:
        """Let the catalog spill the batch again."""
        self.catalog.unpin(self.buffer_id)

    def is_spilled(self) -> bool:
        return self.catalog.tier(self.buffer_id) != StorageTier.DEVICE

    def demote(self) -> None:
        """Push the batch off the device tier (to the host, or on to disk
        past the host limit)."""
        self.catalog.demote(self.buffer_id)

    def materialize_slice(self, lo: int, hi: int):
        """Rows ``[lo, hi)`` on the device; a spilled batch stays spilled
        and only the slice's bytes move."""
        assert not self._closed, "use after close"
        return self.catalog.acquire_slice(self.buffer_id, lo, hi)

    def close(self) -> None:
        if not self._closed:
            self.catalog.unregister(self.buffer_id)
            self._closed = True
