"""Columnar batches: columns plus a row count held on the device.

Counterpart of ``spark_rapids_tpu/columnar/batch.py``.  The live row
count is a device scalar (``rows_dev``) so operators chain without host
syncs; ``num_rows`` reads it to the host once and caches it.  Rows
``[0, num_rows)`` are live; the rest is capacity padding.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .column import (MIN_CAPACITY, Column, bucket_capacity, concat_columns,
                     null_column)
from .schema import Schema


class ColumnarBatch:
    def __init__(self, schema: Schema, columns: List[Column], rows,
                 device=None):
        self.schema = schema
        self.columns = list(columns)
        if columns:
            device = columns[0].device
        self.device = torch.device(device)
        if isinstance(rows, int):
            self._rows_host: Optional[int] = rows
            self.rows_dev = torch.tensor(rows, dtype=torch.int64,
                                         device=self.device)
        else:
            self._rows_host = None
            self.rows_dev = rows.to(torch.int64).reshape(())

    @staticmethod
    def empty(schema: Schema, device) -> "ColumnarBatch":
        """No rows, at the smallest capacity."""
        cols = [null_column(f.dtype, MIN_CAPACITY, device) for f in schema]
        return ColumnarBatch(schema, cols, 0, device=device)

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def rows_known(self) -> Optional[int]:
        """Host row count if already read, else None (no sync)."""
        return self._rows_host

    @property
    def rows(self):
        """The host row count if known, else the device count."""
        return self._rows_host if self._rows_host is not None \
            else self.rows_dev

    @property
    def num_rows(self) -> int:
        """Host row count; the first call on a device count syncs."""
        if self._rows_host is None:
            self._rows_host = int(self.rows_dev.item())
        return self._rows_host

    def nbytes(self) -> int:
        """Device bytes the batch's buffers hold (a string slice counts
        the byte buffer it shares with the batch it was cut from)."""
        n = 0
        for c in self.columns:
            n += c.data.numel() * c.data.element_size() + c.validity.numel()
            offsets = getattr(c, "offsets", None)
            if offsets is not None:
                n += offsets.numel() * offsets.element_size()
        return n

    def live_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.rows_dev

    def gather(self, idx: torch.Tensor, rows) -> "ColumnarBatch":
        """Rows ``idx`` of every column; the first ``rows`` are live."""
        live = torch.arange(idx.shape[0], device=self.device) < (
            rows if isinstance(rows, int) else rows.reshape(()))
        cols = [c.gather(idx, live) for c in self.columns]
        return ColumnarBatch(self.schema, cols, rows, device=self.device)

    def slice(self, lo: int, n: int) -> "ColumnarBatch":
        """Rows ``[lo, lo + n)`` as a batch of capacity bucket_capacity(n)."""
        cap = bucket_capacity(n)
        cols = [c.slice(lo, n).pad_to(cap) for c in self.columns]
        return ColumnarBatch(self.schema, cols, n, device=self.device)

    def __repr__(self):
        rows = self._rows_host if self._rows_host is not None else "?"
        return (f"ColumnarBatch(rows={rows}, cap={self.capacity}, "
                f"{self.schema})")


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Live rows of every batch, in order, in one batch (reads each
    batch's row count to the host)."""
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_capacity(total)
    cols = [concat_columns([b.columns[ci] for b in batches], counts, cap)
            for ci in range(len(schema))]
    return ColumnarBatch(schema, cols, total, device=batches[0].device)
