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

from typing import Dict, List, Optional

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


def choose_rows(cols, which: torch.Tensor, valid: torch.Tensor):
    """Row i of ``cols[which[i]]`` (string columns of one capacity) as a
    new column; rows where ``valid`` is False come out null and empty."""
    from ..columnar.column import StringColumn
    starts, lens, base = [], [], 0
    for c in cols:
        starts.append(c.offsets[:-1].to(torch.int64) + base)
        lens.append(string_lengths(c.offsets))
        base += int(c.data.shape[0])
    rows = torch.arange(which.shape[0], device=which.device)
    start = torch.stack(starts)[which, rows]
    n = torch.where(valid, torch.stack(lens)[which, rows], 0)
    mb = max(c.max_bytes for c in cols)
    offsets, data = copy_rows(torch.cat([c.data for c in cols]), start, n,
                              mb)
    return StringColumn(offsets, data, valid, mb)


def _shift_case(col, lo: int, hi: int, delta: int):
    """``col`` with each byte in [lo, hi] moved by ``delta``: the ASCII
    letters alone, as the reference's byte tables do (a byte of a
    multi-byte UTF-8 character is 0x80 or more, and stays)."""
    d = col.data
    data = torch.where((d >= lo) & (d <= hi), d + delta, d).to(torch.uint8)
    return type(col)(col.offsets, data, col.validity, col.max_bytes)


def upper(col):
    """ASCII upper case (``strings.upper`` of the reference)."""
    return _shift_case(col, ord("a"), ord("z"), -32)


def lower(col):
    """ASCII lower case (``strings.lower`` of the reference)."""
    return _shift_case(col, ord("A"), ord("Z"), 32)


class LiteralBytes:
    """A string literal's UTF-8 bytes and their copy on each device.  The
    expression that holds one uploads its literal once per device, never
    per batch."""

    def __init__(self, text):
        self.raw = text if isinstance(text, bytes) else \
            str(text).encode("utf-8")
        self._on: Dict[str, torch.Tensor] = {}

    def __len__(self):
        return len(self.raw)

    def on(self, device) -> torch.Tensor:
        t = self._on.get(str(device))
        if t is None:
            t = torch.tensor(list(self.raw), dtype=torch.uint8,
                             device=device)
            self._on[str(device)] = t
        return t


def held_literal(held: Dict, text) -> LiteralBytes:
    """``text``'s LiteralBytes in an expression's ``held`` dict (shared
    by the expression's bound copies), made on first use."""
    lit = held.get(text)
    if lit is None:
        lit = held[text] = LiteralBytes(text)
    return lit


def _bytes_at(col, pos: torch.Tensor, m: int) -> torch.Tensor:
    """[cap, m] bytes of the data buffer from per-row byte positions."""
    k = torch.arange(m, device=col.offsets.device)
    idx = (pos.to(torch.int64)[:, None] + k).clamp(
        0, max(col.data.shape[0] - 1, 0))
    return col.data[idx]


def _match_at(col, pos: torch.Tensor, lit: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the bytes at ``pos`` are ``lit`` (not bounds-checked)."""
    want = lit.on(col.offsets.device)
    return (_bytes_at(col, pos, len(lit)) == want).all(dim=1)


def equal_literal(col, lit: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row's bytes equal the literal's."""
    lens = string_lengths(col.offsets)
    eq = lens == len(lit)
    if lit and len(lit) <= col.max_bytes:
        eq = eq & _match_at(col, col.offsets[:-1], lit)
    elif lit:
        eq = torch.zeros_like(eq)
    return eq


def starts_with(col, prefix: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row begins with ``prefix``."""
    lens = string_lengths(col.offsets)
    if not prefix:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(prefix) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    return (lens >= len(prefix)) & _match_at(col, col.offsets[:-1], prefix)


def ends_with(col, suffix: LiteralBytes) -> torch.Tensor:
    """bool[cap]: the row ends with ``suffix``."""
    lens = string_lengths(col.offsets)
    if not suffix:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(suffix) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    return (lens >= len(suffix)) & _match_at(col, col.offsets[1:] -
                                             len(suffix), suffix)


def contains(col, needle: LiteralBytes) -> torch.Tensor:
    """bool[cap]: ``needle`` occurs in the row.  Every byte position of
    the buffer is compared with the needle once; a row holds a match if
    one starts in ``[start, end - len(needle)]``, counted by a prefix sum
    of the match flags."""
    lens = string_lengths(col.offsets)
    if not needle:
        return torch.ones_like(lens, dtype=torch.bool)
    if len(needle) > col.max_bytes:
        return torch.zeros_like(lens, dtype=torch.bool)
    nbytes = col.data.shape[0]
    pos = torch.arange(nbytes, device=col.offsets.device)
    hit = _match_at(col, pos, needle) & (pos + len(needle) <= nbytes)
    cum = torch.zeros(nbytes + 1, dtype=torch.int64,
                      device=col.offsets.device)
    cum[1:] = torch.cumsum(hit.to(torch.int64), 0)
    starts = col.offsets[:-1].to(torch.int64).clamp(0, nbytes)
    ends = torch.maximum(col.offsets[1:].to(torch.int64) - len(needle) + 1,
                         starts).clamp(0, nbytes)
    return (cum[ends] - cum[starts]) > 0


def _char_positions(offsets: torch.Tensor, data: torch.Tensor):
    """(first, nchars, byte_of) of each row's UTF-8 characters: the
    buffer's count of character starts (bytes that are not continuation
    bytes, as the reference's ``char_length`` counts them) before the
    row, the row's character count, and ``byte_of(k)``, the byte position
    of each row's character ``k`` (its end for ``k >= nchars``)."""
    is_start = (data & 0xC0) != 0x80
    cs = torch.zeros(data.shape[0] + 1, dtype=torch.int64,
                     device=data.device)
    cs[1:] = torch.cumsum(is_start.to(torch.int64), 0)
    starts = offsets[:-1].to(torch.int64)
    ends = offsets[1:].to(torch.int64)
    first = cs[starts]
    nchars = cs[ends] - first

    def byte_of(k: torch.Tensor) -> torch.Tensor:
        # the first byte whose inclusive count of starts passes the
        # global ordinal of character k is that character's first byte
        pos = torch.searchsorted(cs[1:], first + k, right=True)
        return torch.where(k >= nchars, ends, pos)
    return nchars, byte_of


def _substring_offsets(offsets: torch.Tensor, data: torch.Tensor,
                       start: int, length: Optional[int]):
    """Spark's substring positions, in characters: a 1-based ``start``, 0
    read as 1, a negative one counted from the end (clamped to the first
    character); at most ``length`` characters.  Returns (source byte
    start, byte count) per row."""
    lens, byte_of = _char_positions(offsets, data)
    if start > 0:
        s = torch.full_like(lens, start - 1)
    elif start < 0:
        s = (lens + start).clamp(min=0)
    else:
        s = torch.zeros_like(lens)
    s = torch.minimum(s, lens)
    room = lens - s
    n = room if length is None else torch.clamp(room, max=max(length, 0))
    src = byte_of(s)
    return src, byte_of(s + n) - src


def substring(col, start: int, length: Optional[int]):
    """``substring(col, start, length)`` by characters (Spark's semantics;
    the reference's device kernel counts bytes and cuts a multi-byte
    character).  A character is at most 4 bytes, so the result's host
    bound is ``min(max_bytes, 4 * length)``: no size is read from the
    device."""
    from ..columnar.column import StringColumn
    src, n = _substring_offsets(col.offsets, col.data, start, length)
    n = torch.where(col.validity, n, 0).to(torch.int32)
    mb = col.max_bytes if length is None else \
        min(col.max_bytes, 4 * max(length, 0))
    offsets, data = copy_rows(col.data, src, n, mb)
    return StringColumn(offsets, data, col.validity, mb)


def concat(parts, capacity: int, device):
    """Byte concatenation of ``parts``, each a string column or a
    LiteralBytes; null if any column part is null.  The output's
    host bound is the sum of the parts' bounds."""
    from ..columnar.column import StringColumn
    valid = torch.ones(capacity, dtype=torch.bool, device=device)
    lens = []
    for p in parts:
        if isinstance(p, LiteralBytes):
            lens.append(None)
        else:
            valid = valid & p.validity
            lens.append(string_lengths(p.offsets).to(torch.int64))
    total = torch.zeros(capacity, dtype=torch.int64, device=device)
    for p, ln in zip(parts, lens):
        total = total + (len(p) if ln is None else ln)
    total = torch.where(valid, total, 0)
    offsets = torch.zeros(capacity + 1, dtype=torch.int32, device=device)
    offsets[1:] = torch.cumsum(total, 0)
    bounds = [len(p) if isinstance(p, LiteralBytes) else p.max_bytes
              for p in parts]
    size = capacity * sum(bounds)
    out = torch.zeros(size + 1, dtype=torch.uint8, device=device)
    base = offsets[:-1].to(torch.int64)
    for p, ln, mb in zip(parts, lens, bounds):
        if mb == 0:
            continue
        k = torch.arange(mb, device=device)
        if ln is None:
            inb = valid[:, None] & (k[None, :] < mb)
            src = p.on(device).expand(capacity, mb)
        else:
            inb = valid[:, None] & (k[None, :] < ln[:, None])
            src = _bytes_at(p, p.offsets[:-1], mb)
        # bytes past a part's length go to one spare slot, dropped below
        dst = torch.where(inb, base[:, None] + k, size)
        out.scatter_(0, dst.reshape(-1), src.reshape(-1))
        base = base + torch.where(valid, mb if ln is None else ln, 0)
    return StringColumn(offsets, out[:max(size, 1)], valid, sum(bounds))
