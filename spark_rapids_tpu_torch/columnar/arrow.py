"""pyarrow <-> device tensor interop.

Counterpart of ``spark_rapids_tpu/columnar/arrow.py`` for fixed-width
types, dates and strings (a date32 moves as its int32 days).  Uploads
move only live rows and pad on the device; a string column moves its
offsets (rebased to 0) and its bytes.  A ``decimal128(p <= 18, s)``
moves as its unscaled int64s, read from and written to the 16-byte
values' buffer at once (the low word of each, its high word checked to
be the low one's sign); the reference's per-row ``Decimal`` loop would
take minutes at 28.8M rows.  An upload that meets a device
OOM frees what it can and runs once more (``memory/pressure.oom_retry``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import pyarrow as pa
import torch

from ..memory.pressure import oom_retry
from . import dtypes as T
from .batch import ColumnarBatch
from .column import Column, StringColumn, bucket_capacity
from .schema import Field, Schema


def schema_from_arrow(s: pa.Schema, lenient: bool = False) -> Schema:
    """Engine schema of an arrow schema; with ``lenient`` (a file's
    schema) a type the port does not carry becomes ``UnsupportedType``."""
    return Schema(Field(f.name, T.from_arrow(f.type, lenient), f.nullable)
                  for f in s)


def _string_from_arrow(arr, cap: int, device) -> StringColumn:
    if pa.types.is_large_string(arr.type):
        arr = arr.cast(pa.string())
    n = len(arr)
    offs = np.frombuffer(arr.buffers()[1], dtype=np.int32,
                         count=arr.offset + n + 1)[arr.offset:]
    base, end = int(offs[0]), int(offs[-1])
    raw = arr.buffers()[2]
    data = np.frombuffer(raw, dtype=np.uint8)[base:end] if raw is not None \
        and end > base else np.zeros(0, np.uint8)
    offsets = np.empty(cap + 1, dtype=np.int32)
    offsets[:n + 1] = offs - base
    offsets[n + 1:] = end - base
    lens = np.diff(offsets[:n + 1])
    valid = np.zeros(cap, dtype=np.bool_)
    valid[:n] = ~np.asarray(arr.is_null()) if arr.null_count else True
    return StringColumn(torch.from_numpy(offsets).to(device),
                        torch.from_numpy(data.copy()).to(device),
                        torch.from_numpy(valid).to(device),
                        int(lens.max()) if n else 0)


def _upload(arr: np.ndarray, dtype: T.DType, cap: int, device) -> torch.Tensor:
    # arrow buffers are read-only: copy into memory torch may own
    t = torch.from_numpy(np.array(arr, dtype=dtype.np_dtype, copy=True))
    t = t.to(device)
    if t.shape[0] < cap:
        t = torch.cat([t, t.new_zeros(cap - t.shape[0])])
    return t


def _decimal_words(arr) -> np.ndarray:
    """The unscaled int64s of a ``decimal128`` array (0 where null)."""
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * (arr.offset + n))[2 * arr.offset:]
    lo, hi = words[0::2], words[1::2]
    valid = ~np.asarray(arr.is_null()) if arr.null_count else None
    wide = hi != (lo >> 63)
    if valid is not None:
        wide &= valid
    if wide.any():
        raise ValueError(f"{arr.type}: a value does not fit an int64")
    return lo if valid is None else np.where(valid, lo, 0)


def _decimal_to_arrow(data: np.ndarray, valid: np.ndarray,
                      dtype: T.DecimalType) -> pa.Array:
    """A ``decimal128`` array of unscaled int64s: each value's 16 bytes
    are the int64 and its sign word."""
    n = len(data)
    words = np.empty((n, 2), dtype=np.int64)
    words[:, 0] = data
    words[:, 1] = data >> 63
    bitmap = None
    if not valid.all():
        bitmap = pa.array(valid, type=pa.bool_()).buffers()[1]
    return pa.Array.from_buffers(dtype.arrow_type, n, [
        bitmap, pa.py_buffer(words.tobytes())],
        null_count=int(n - valid.sum()))


def _column_from_arrow(arr, dtype: T.DType, cap: int, device) -> Column:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks() if arr.num_chunks != 1 else arr.chunk(0)
    if dtype == T.STRING:
        return _string_from_arrow(arr, cap, device)
    if isinstance(dtype, T.UnsupportedType):
        raise NotImplementedError(f"column type {arr.type} is not "
                                  f"supported by the port")
    n = len(arr)
    if dtype.is_decimal:
        valid_np = ~np.asarray(arr.is_null()) if arr.null_count else \
            np.ones(n, np.bool_)
        return Column(dtype, _upload(_decimal_words(arr), dtype, cap, device),
                      _upload(valid_np, T.BOOL, cap, device))
    if dtype == T.DATE:
        arr = arr.cast(pa.int32())
    if arr.null_count:
        valid_np = ~np.asarray(arr.is_null())
        data_np = np.asarray(arr.fill_null(dtype.np_dtype.type(0)))
        valid = _upload(valid_np, T.BOOL, cap, device)
    else:
        data_np = arr.to_numpy(zero_copy_only=False)
        valid = torch.arange(cap, device=device) < n
    return Column(dtype, _upload(data_np, dtype, cap, device), valid)


def from_arrow(table: pa.Table, device) -> ColumnarBatch:
    """Upload an arrow table as one batch padded to bucket_capacity."""
    return oom_retry(_from_arrow, table, device)


def _from_arrow(table: pa.Table, device) -> ColumnarBatch:
    schema = schema_from_arrow(table.schema)
    n = table.num_rows
    cap = bucket_capacity(n)
    cols = [_column_from_arrow(table.column(i), f.dtype, cap, device)
            for i, f in enumerate(schema)]
    return ColumnarBatch(schema, cols, n, device=device)


def from_numpy_columns(datas: Sequence[np.ndarray],
                       validities: Sequence[np.ndarray], schema: Schema,
                       device, num_rows: int = None) -> ColumnarBatch:
    """Batch from the numpy arrays a reference ``ColumnarBatch`` holds
    (``np.asarray(col.data)``, ``np.asarray(col.validity)``), capacity
    and padding included, so both packages see identical batches."""
    cols = []
    for f, d, v in zip(schema, datas, validities):
        data = torch.from_numpy(np.array(d, f.dtype.np_dtype, copy=True))
        valid = torch.from_numpy(np.array(v, np.bool_, copy=True))
        cols.append(Column(f.dtype, data.to(device), valid.to(device)))
    rows = int(num_rows) if num_rows is not None else int(len(datas[0]))
    return ColumnarBatch(schema, cols, rows, device=device)


def to_arrow(batch: ColumnarBatch) -> pa.Table:
    """Live rows of a batch as an arrow table (one device->host copy per
    buffer)."""
    n = batch.num_rows
    arrays = []
    for f, c in zip(batch.schema, batch.columns):
        if isinstance(c, StringColumn):
            arrays.append(_string_to_arrow(c, n))
            continue
        if f.dtype == T.NULL:
            arrays.append(pa.nulls(n))
            continue
        data = c.data[:n].cpu().numpy()
        valid = c.validity[:n].cpu().numpy()
        if f.dtype.is_decimal:
            arrays.append(_decimal_to_arrow(data, valid, f.dtype))
            continue
        mask = None if valid.all() else ~valid
        arrays.append(pa.array(data, type=f.dtype.arrow_type, mask=mask))
    return pa.Table.from_arrays(arrays, names=batch.schema.names)


def _string_to_arrow(c: StringColumn, n: int) -> pa.Array:
    offs = c.offsets[:n + 1].cpu().numpy().astype(np.int64)
    valid = c.validity[:n].cpu().numpy()
    base = int(offs[0]) if n else 0
    end = int(offs[-1]) if n else 0
    data = c.data[base:end].cpu().numpy() if end > base else \
        np.zeros(0, np.uint8)
    offsets = (offs - base).astype(np.int32)
    bitmap = None
    if not valid.all():
        bitmap = pa.array(valid, type=pa.bool_()).buffers()[1]
    return pa.Array.from_buffers(pa.string(), n, [
        bitmap, pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(data.tobytes())], null_count=int(n - valid.sum()))


def empty_table(schema: Schema) -> pa.Table:
    return pa.Table.from_arrays(
        [pa.array([], type=f.dtype.arrow_type) for f in schema],
        names=schema.names)
