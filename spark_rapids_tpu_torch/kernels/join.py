"""Join kernels: sort-based build, binary-search probe, match expansion.

Counterpart of ``spark_rapids_tpu/kernels/join.py``.  The build side is
sorted by its canonical key words; each probe row binary-searches its
lower and upper bound, and (lo, count) pairs expand into flat gather
maps by a prefix sum and ``searchsorted``.  Join types other than inner
change the counts before the expansion (``outer_counts``); semi and
anti joins select probe rows by compaction instead of expanding them
(``basic.compact_indices``).  Counts and their prefix sums are int64.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from . import canon
from .sort import sorted_words


@dataclasses.dataclass
class BuildTable:
    """Sorted build side: key words plus the permutation back to rows."""
    sorted_words: List[torch.Tensor]
    perm: torch.Tensor
    capacity: int


def build(words: List[torch.Tensor]) -> BuildTable:
    ws, perm = sorted_words(words)
    return BuildTable(ws, perm, int(perm.shape[0]))


def _bsearch(build_words: List[torch.Tensor],
             probe_words: List[torch.Tensor], upper: bool) -> torch.Tensor:
    """Lower (or upper) bound of each probe tuple in the sorted build."""
    bcap = build_words[0].shape[0]
    pcap = probe_words[0].shape[0]
    dev = probe_words[0].device
    steps = max(1, (bcap - 1).bit_length() + 1)
    lo = torch.zeros(pcap, dtype=torch.int64, device=dev)
    hi = torch.full((pcap,), bcap, dtype=torch.int64, device=dev)
    prows = torch.arange(pcap, device=dev)
    for _ in range(steps):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, bcap - 1)
        if upper:
            # first index where probe < build[mid]
            go_right = ~canon.words_less(probe_words, prows, build_words,
                                         midc)
        else:
            # first index where NOT build[mid] < probe
            go_right = canon.words_less(build_words, midc, probe_words,
                                        prows)
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


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
    lo = _bsearch(bt.sorted_words, probe_words, upper=False)
    hi = _bsearch(bt.sorted_words, probe_words, upper=True)
    usable = probe_live
    for i in rank_words:
        usable = usable & (probe_words[i] == 1)
    counts = torch.where(usable, hi - lo, 0)
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
