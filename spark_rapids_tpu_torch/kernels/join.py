"""Join kernels: sort-based build, binary-search probe, match expansion.

Counterpart of ``spark_rapids_tpu/kernels/join.py``.  The build side is
sorted by its canonical key words (on the card, with the probe kernel's
index, ``cuda_ops.probe_index``, made once); each probe row searches its
lower and upper bound (``cuda_ops.join_probe``: one launch on the card;
``bounds``, a stable merge of build and probe words, is its plain
version), and (lo, count) pairs expand into flat gather maps by a prefix
sum and ``searchsorted``.  Join types other than inner change the counts
before the expansion (``outer_counts``); semi and anti joins select probe
rows by compaction instead of expanding them (``basic.compact_indices``).
Counts and their prefix sums are int64.

A build side of one integer, DATE or DECIMAL key whose valid values span
at most ``DIRECT_MAX_RANGE`` may instead be probed by direct address
(``direct_tables``, the reference's ``_prepare_direct``): two int32
tables over the key's range give each probe row its count and first
position in the sorted build (``cuda_ops.direct_probe``, which reads
the stream key column's values and validity), the same (lo, counts) as
the search.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn, bucket_capacity
from . import canon, cuda_ops
from .basic import SIGN64
from .sort import sorted_words

#: most slots of a direct-address table (the reference's
#: ``_DIRECT_MAX_RANGE``: 64 MB of int32 per table)
DIRECT_MAX_RANGE = 1 << 24
#: least stream capacity of a partition that probes by direct address
#: (the reference's rule: a smaller stream keeps the search, which needs
#: no host read of the build's range)
DIRECT_MIN_STREAM = 1 << 19


@dataclasses.dataclass
class BuildTable:
    """Sorted build side: key words plus the permutation back to rows, and
    on the card the probe kernel's index of the words (None on the CPU)."""
    sorted_words: List[torch.Tensor]
    perm: torch.Tensor
    capacity: int
    index: Optional[cuda_ops.ProbeIndex] = None


def build(words: List[torch.Tensor]) -> BuildTable:
    ws, perm = sorted_words(words)
    index = cuda_ops.probe_index(ws) if ws[0].is_cuda else None
    return BuildTable(ws, perm, int(perm.shape[0]), index)


def bounds(build_words: List[torch.Tensor],
           probe_words: List[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower and upper bound of each probe tuple in the sorted build
    (unsigned lexicographic): the plain version of ``cuda_ops.join_probe``.

    Build and probe tuples merge by one stable sort per word, last word
    first, so a build tuple sorts before an equal probe tuple.  A probe
    row's upper bound is then the number of build rows before it, and its
    lower bound that number less the build rows in its run of equal
    tuples."""
    n = build_words[0].shape[0]
    m = probe_words[0].shape[0]
    dev = probe_words[0].device
    keys = [torch.cat([b, p]) ^ SIGN64
            for b, p in zip(build_words, probe_words)]
    order = torch.arange(n + m, device=dev)
    for w in reversed(keys):
        order = order[torch.argsort(w[order], stable=True)]
    is_build = order < n
    before = torch.cumsum(is_build, 0)
    new_run = torch.zeros(n + m, dtype=torch.bool, device=dev)
    new_run[:1] = True
    for w in keys:
        s = w[order]
        new_run[1:] |= s[1:] != s[:-1]
    run = torch.cumsum(new_run, 0) - 1
    run_builds = torch.zeros(n + m, dtype=torch.int64, device=dev)
    run_builds.index_add_(0, run, is_build.to(torch.int64))
    probe = ~is_build
    at = order[probe] - n
    lo = torch.empty(m, dtype=torch.int64, device=dev)
    hi = torch.empty(m, dtype=torch.int64, device=dev)
    lo[at] = (before - run_builds[run])[probe]
    hi[at] = before[probe]
    return lo, hi


@dataclasses.dataclass
class JoinCounts:
    lo: torch.Tensor       # per-probe-row first build position
    counts: torch.Tensor   # per-probe-row match count
    matched: torch.Tensor  # counts > 0


def probe_counts(bt: BuildTable, probe_words: List[torch.Tensor],
                 probe_live: torch.Tensor,
                 rank_words: List[int]) -> JoinCounts:
    """Matches of each probe row.  A probe row with a null key (rank word
    0) or past the live rows (rank 2) matches nothing; ``rank_words``
    lists the positions of every key's rank word."""
    lo, counts = cuda_ops.join_probe(
        bt.sorted_words, [w.contiguous() for w in probe_words],
        probe_live.contiguous(), rank_words, bt.index)
    return JoinCounts(lo, counts, counts > 0)


@dataclasses.dataclass
class DirectTables:
    """A build key's direct-address tables: ``hist`` and ``excl`` int32
    over ``bucket_capacity(smax - smin + 1)`` slots, ``smin`` / ``smax``
    the least and greatest valid key (signed; the order words are these
    XOR the sign bit), ``nnull`` and ``nvalid`` the build's live null and
    valid rows."""
    smin: int
    smax: int
    hist: torch.Tensor
    excl: torch.Tensor
    nnull: int
    nvalid: int


def direct_keyable(dtype) -> bool:
    """Whether a key of ``dtype`` may be probed by direct address: an
    integer, a DATE, or a DECIMAL by its unscaled int64 (the reference's
    ``tpu_join.py:268``)."""
    return dtype.is_integral or dtype.is_decimal or dtype == T.DATE


def direct_tables(col: Column, rows) -> Optional[DirectTables]:
    """The direct-address tables of a build key column of ``rows`` live
    rows (int or device count), or None when the key is not an integer,
    DATE or DECIMAL or its valid values span more than ``DIRECT_MAX_RANGE``.
    Reads the key's range and null count to the host: one read per
    build.  ``excl`` indexes the build as ``build`` sorts it: nulls first
    (rank word 0), then the valid keys, then the dead rows."""
    if isinstance(col, StringColumn) or not direct_keyable(col.dtype):
        return None
    dev = col.data.device
    live = torch.arange(col.capacity, device=dev) < rows
    valid = col.validity & live
    signed = canon.value_words(col)[0] ^ SIGN64
    big = torch.iinfo(torch.int64)
    smin, smax, nvalid, nlive = torch.stack([
        torch.where(valid, signed, big.max).min(),
        torch.where(valid, signed, big.min).max(),
        valid.sum(), live.sum()]).tolist()
    if nvalid == 0:
        # the reference's empty range: one slot, no row in it
        smin = smax = big.min
    span = smax - smin + 1
    if span <= 0 or span > DIRECT_MAX_RANGE:
        return None
    slots = bucket_capacity(span)
    idx = torch.where(valid, signed - smin, slots)
    hist = torch.zeros(slots + 1, dtype=torch.int32, device=dev).index_add_(
        0, idx, torch.ones_like(idx, dtype=torch.int32))[:slots]
    nnull = nlive - nvalid
    excl = (torch.cumsum(hist, 0) - hist + nnull).to(torch.int32)
    return DirectTables(smin, smax, hist.contiguous(), excl, nnull, nvalid)


def direct_counts(dt: DirectTables, key: Column, rows) -> JoinCounts:
    """``probe_counts`` of a stream key column of ``rows`` live rows (an
    int or a device count) by direct address: the kernel reads the
    column's values and validity as they are."""
    lo, counts = cuda_ops.direct_probe(key.data.contiguous(),
                                       key.validity.contiguous(), rows,
                                       dt.smin, dt.smax, dt.hist, dt.excl,
                                       dt.nnull, dt.nvalid)
    return JoinCounts(lo, counts, counts > 0)


def outer_counts(counts: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Counts of an outer join's stream side: a live row without a match
    expands to one row, whose build side the expansion leaves null."""
    return torch.where((counts == 0) & live, 1, counts)


def mark_matched(flags: torch.Tensor, build_idx: torch.Tensor,
                 hit: torch.Tensor) -> None:
    """Set ``flags[build_idx]`` where ``hit``, on the device.  ``flags``
    has one slot past the build rows, which takes the misses."""
    spare = flags.shape[0] - 1
    flags[torch.where(hit, build_idx, spare)] = True


def expand_matches(lo: torch.Tensor, counts: torch.Tensor,
                   perm: torch.Tensor, out_cap: int, start: int = 0):
    """(lo, counts) -> flat (probe_idx, build_idx, live, total) for output
    rows ``start .. start + out_cap - 1``.

    Output row t belongs to probe row p where excl[p] <= t < incl[p];
    its build position is lo[p] + (t - excl[p]).  A chunk of a larger
    expansion starts past 0, so one probe row's matches may split across
    chunks."""
    incl = torch.cumsum(counts, 0)
    excl = incl - counts
    total = incl[-1]
    t = torch.arange(start, start + out_cap, device=lo.device)
    p = torch.searchsorted(incl, t, right=True)
    pc = p.clamp(0, counts.shape[0] - 1)
    build_pos = lo[pc] + (t - excl[pc])
    build_pos = build_pos.clamp(0, perm.shape[0] - 1)
    build_idx = perm[build_pos]
    live = t < total
    return pc, build_idx, live, total
