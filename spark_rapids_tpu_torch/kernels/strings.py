"""String kernels over the Arrow offsets + bytes device layout.

Counterpart of ``spark_rapids_tpu/kernels/strings.py``.  A string column
is ``offsets`` int32[cap + 1] and ``data`` uint8[bytes]; row i is bytes
``[offsets[i], offsets[i + 1])``.  Every op is integer torch work over
those two buffers: byte gathers, packing into 64-bit words, and one
scatter to compact gathered rows.  Sizing a gather's byte buffer needs no
host read: a column carries a host bound on its longest string
(``max_bytes``), and the buffer holds ``rows x max_bytes``.

Key words (sort, group-by, join): ``num_words`` big-endian 64-bit words
of each string's bytes, zero-padded, then its length, so unsigned
lexicographic word order is byte order with shorter prefixes first.
Columns compared against each other must agree on ``num_words``
(``needed_key_words`` over all of them).  Partition ids take
``partition_words`` instead: the string's own words folded into one, so
a string's id does not depend on the batch it arrives in.
"""
from __future__ import annotations

from typing import List

import torch

from .basic import mix64

#: seed of the partition fold of a string's words
FOLD_SEED = 0x5851F42D4C957F2D


def string_lengths(offsets: torch.Tensor) -> torch.Tensor:
    return (offsets[1:] - offsets[:-1]).to(torch.int32)


def pack_words(offsets: torch.Tensor, data: torch.Tensor,
               num_words: int) -> torch.Tensor:
    """[cap, num_words] big-endian words (int64 bit patterns) of each
    string's first ``8 * num_words`` bytes, zero-padded."""
    starts = offsets[:-1].to(torch.int64)
    lens = (offsets[1:] - offsets[:-1]).to(torch.int64)
    k = torch.arange(num_words * 8, device=offsets.device)
    idx = (starts[:, None] + k[None, :]).clamp(0, max(data.shape[0] - 1, 0))
    byts = torch.where(k[None, :] < lens[:, None], data[idx].to(torch.int64),
                       0)
    w = byts.reshape(-1, num_words, 8)
    shifts = 8 * (7 - torch.arange(8, device=offsets.device))
    out = torch.zeros(w.shape[:2], dtype=torch.int64, device=offsets.device)
    for j in range(8):
        out |= w[:, :, j] << int(shifts[j])
    return out


def needed_key_words(col) -> int:
    """Word count (a power of two) that holds the column's longest
    string, from the host bound it carries."""
    num_words = max(1, -(-col.max_bytes // 8))
    return 1 << (num_words - 1).bit_length()


def string_key_words(col, num_words: int = None) -> List[torch.Tensor]:
    """Byte words + the length word (int64 bit patterns), one per row of
    the column's capacity."""
    if num_words is None:
        num_words = needed_key_words(col)
    words = pack_words(col.offsets, col.data, num_words)
    out = [words[:, i] for i in range(num_words)]
    out.append(string_lengths(col.offsets).to(torch.int64))
    return out


def partition_words(col) -> List[torch.Tensor]:
    """[fold, length]: each row's own ``ceil(len / 8)`` packed words
    folded by ``mix64`` (padding words skipped), then its length.  The
    pair is a function of the string alone, whatever width its batch
    needs, so one key lands in one partition."""
    nw = needed_key_words(col)
    lens = string_lengths(col.offsets).to(torch.int64)
    own = (lens + 7) // 8
    words = pack_words(col.offsets, col.data, nw)
    h = torch.full_like(lens, FOLD_SEED)
    for i in range(nw):
        h = torch.where(own > i, mix64(h ^ words[:, i]), h)
    return [h, lens]


def copy_rows(data: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
              max_bytes: int):
    """Rows ``[starts[i], starts[i] + lens[i])`` of ``data`` packed one
    after another: (offsets int32[n + 1], bytes uint8).  The byte buffer
    holds ``n * max_bytes`` (every ``lens[i] <= max_bytes``), so its size
    is known without a host read."""
    n = lens.shape[0]
    dev = lens.device
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(lens, 0)
    size = n * max_bytes
    if size == 0:
        return offsets, torch.zeros(1, dtype=torch.uint8, device=dev)
    k = torch.arange(max_bytes, device=dev)
    inb = k[None, :] < lens[:, None]
    src = (starts.to(torch.int64)[:, None] + k).clamp(
        0, max(data.shape[0] - 1, 0))
    # bytes past a row's length go to one spare slot, dropped below
    dst = torch.where(inb, offsets[:-1].to(torch.int64)[:, None] + k, size)
    out = torch.zeros(size + 1, dtype=torch.uint8, device=dev)
    out.scatter_(0, dst.reshape(-1), data[src.reshape(-1)])
    return offsets, out[:size]


def gather_strings(col, indices: torch.Tensor, live: torch.Tensor = None):
    """Rows ``indices`` (clipped into range) as a new column; rows where
    ``live`` is False, and null rows, come out null and empty."""
    from ..columnar.column import StringColumn
    src = indices.clamp(0, max(col.capacity - 1, 0))
    starts = col.offsets[:-1][src]
    lens = string_lengths(col.offsets)[src]
    valid = col.validity[src]
    if live is not None:
        valid = valid & live
    lens = torch.where(valid, lens, 0)
    offsets, data = copy_rows(col.data, starts, lens, col.max_bytes)
    return StringColumn(offsets, data, valid, col.max_bytes)


def equal_literal(col, value: str) -> torch.Tensor:
    """bool[cap]: the row's bytes equal ``value``'s UTF-8 bytes."""
    lit = value.encode("utf-8")
    lens = string_lengths(col.offsets)
    eq = lens == len(lit)
    if lit and len(lit) <= col.max_bytes:
        k = torch.arange(len(lit), device=col.offsets.device)
        idx = (col.offsets[:-1].to(torch.int64)[:, None] + k).clamp(
            0, max(col.data.shape[0] - 1, 0))
        want = torch.tensor(list(lit), dtype=torch.uint8,
                            device=col.offsets.device)
        eq = eq & (col.data[idx] == want).all(dim=1)
    elif lit:
        eq = torch.zeros_like(eq)
    return eq
