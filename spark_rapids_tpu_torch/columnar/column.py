"""Device column vectors: a data tensor plus a validity mask.

Counterpart of ``spark_rapids_tpu/columnar/column.py`` (fixed-width
types and strings).  Columns are padded to a power-of-two *capacity*
(``bucket_capacity``); the live row count travels beside them in the
batch, and rows past it are padding whose validity callers mask off.
A ``StringColumn`` holds Arrow-layout offsets and bytes; its gathers
copy the bytes at once on the device (the reference's lazy
``GatheredStringColumn`` view is not kept).
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import dtypes as T

#: smallest capacity bucket a batch is padded to
MIN_CAPACITY = 1024


def bucket_capacity(n: int) -> int:
    """Power-of-two capacity (at least ``MIN_CAPACITY``) holding n rows."""
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


class Column:
    """One fixed-width column: ``data[cap]`` and ``validity[cap]`` (True =
    valid), both on the same device."""

    __slots__ = ("dtype", "data", "validity")

    def __init__(self, dtype: T.DType, data: torch.Tensor,
                 validity: torch.Tensor):
        self.dtype = dtype
        self.data = data
        self.validity = validity

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_scalar(value, dtype: T.DType, capacity: int,
                    device) -> "Column":
        if value is None:
            data = torch.zeros(capacity, dtype=dtype.torch_dtype,
                               device=device)
            return Column(dtype, data, torch.zeros(capacity, dtype=torch.bool,
                                                   device=device))
        if dtype == T.DATE:
            value = T.date_to_days(value)
        elif dtype.is_decimal:
            value = T.unscaled_of(value, dtype.scale)
        data = torch.full((capacity,), value, dtype=dtype.torch_dtype,
                          device=device)
        return Column(dtype, data, torch.ones(capacity, dtype=torch.bool,
                                              device=device))

    def gather(self, idx: torch.Tensor, live: torch.Tensor = None
               ) -> "Column":
        """Rows ``idx`` (clipped into range); rows where ``live`` is False
        come out null."""
        idx = idx.clamp(0, max(self.capacity - 1, 0))
        data = self.data.index_select(0, idx)
        valid = self.validity.index_select(0, idx)
        if live is not None:
            valid = valid & live
        return Column(self.dtype, data, valid)

    def mask_validity(self, mask: torch.Tensor) -> "Column":
        return Column(self.dtype, self.data, self.validity & mask)

    def slice(self, lo: int, n: int) -> "Column":
        """Rows ``[lo, lo + n)`` (not padded)."""
        return Column(self.dtype, self.data[lo:lo + n],
                      self.validity[lo:lo + n])

    def pad_to(self, capacity: int) -> "Column":
        """Same rows, grown (zero/null padded) or cut to ``capacity``."""
        n = self.capacity
        if n == capacity:
            return self
        if n > capacity:
            return Column(self.dtype, self.data[:capacity],
                          self.validity[:capacity])
        pad = capacity - n
        data = torch.cat([self.data, self.data.new_zeros(pad)])
        valid = torch.cat([self.validity, self.validity.new_zeros(pad)])
        return Column(self.dtype, data, valid)

    def __repr__(self):
        return f"Column({self.dtype}, cap={self.capacity})"


class StringColumn(Column):
    """Arrow-layout strings: ``offsets`` int32[cap + 1], ``data``
    uint8[bytes] (at least one byte), ``validity`` bool[cap], and
    ``max_bytes``, a host bound on any row's byte length that sizes
    gathers without a host read."""

    __slots__ = ("offsets", "max_bytes")

    def __init__(self, offsets: torch.Tensor, data: torch.Tensor,
                 validity: torch.Tensor, max_bytes: int):
        if data.shape[0] == 0:
            data = torch.zeros(1, dtype=torch.uint8, device=offsets.device)
        super().__init__(T.STRING, data, validity)
        self.offsets = offsets
        self.max_bytes = int(max_bytes)

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @staticmethod
    def from_scalar(value, dtype, capacity: int, device) -> "StringColumn":
        raw = b"" if value is None else value.encode("utf-8")
        offsets = (torch.arange(capacity + 1, device=device) * len(raw)).to(
            torch.int32)
        data = torch.tensor(list(raw), dtype=torch.uint8,
                            device=device).repeat(capacity)
        valid = torch.full((capacity,), value is not None, dtype=torch.bool,
                           device=device)
        return StringColumn(offsets, data, valid, len(raw))

    def lengths(self) -> torch.Tensor:
        return (self.offsets[1:] - self.offsets[:-1]).to(torch.int32)

    def gather(self, idx: torch.Tensor, live: torch.Tensor = None
               ) -> "StringColumn":
        from ..kernels.strings import gather_strings
        return gather_strings(self, idx, live)

    def mask_validity(self, mask: torch.Tensor) -> "StringColumn":
        return StringColumn(self.offsets, self.data, self.validity & mask,
                            self.max_bytes)

    def slice(self, lo: int, n: int) -> "StringColumn":
        # offsets may start past 0: a row's bytes are [o[i], o[i + 1])
        return StringColumn(self.offsets[lo:lo + n + 1], self.data,
                            self.validity[lo:lo + n], self.max_bytes)

    def pad_to(self, capacity: int) -> "StringColumn":
        n = self.capacity
        if n == capacity:
            return self
        if n > capacity:
            return self.slice(0, capacity)
        pad = capacity - n
        offsets = torch.cat([self.offsets,
                             self.offsets[-1:].expand(pad)])
        valid = torch.cat([self.validity, self.validity.new_zeros(pad)])
        return StringColumn(offsets, self.data, valid, self.max_bytes)

    def __repr__(self):
        return f"StringColumn(cap={self.capacity}, max_bytes={self.max_bytes})"


def concat_columns(cols: Sequence[Column], counts: Sequence[int],
                   capacity: int) -> Column:
    """The first ``counts[i]`` rows of each column, in order, padded to
    ``capacity``."""
    first = cols[0]
    if isinstance(first, StringColumn):
        from ..kernels.strings import copy_rows
        starts, lens, valid, base = [], [], [], 0
        for c, n in zip(cols, counts):
            starts.append(c.offsets[:n].to(torch.int64) + base)
            lens.append(c.lengths()[:n])
            valid.append(c.validity[:n])
            base += int(c.data.shape[0])
        mb = max(c.max_bytes for c in cols)
        offsets, data = copy_rows(torch.cat([c.data for c in cols]),
                                  torch.cat(starts), torch.cat(lens), mb)
        return StringColumn(offsets, data, torch.cat(valid), mb).pad_to(
            capacity)
    data = torch.cat([c.data[:n] for c, n in zip(cols, counts)])
    valid = torch.cat([c.validity[:n] for c, n in zip(cols, counts)])
    return Column(first.dtype, data, valid).pad_to(capacity)


def null_column(dtype: T.DType, capacity: int, device) -> Column:
    """An all-null column of ``dtype``."""
    if dtype == T.STRING:
        return StringColumn.from_scalar(None, dtype, capacity, device)
    return Column.from_scalar(None, dtype, capacity, device)
