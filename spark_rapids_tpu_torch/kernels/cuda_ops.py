"""Hand-written CUDA kernels for Hopper, and their plain torch versions.

Counterpart of ``spark_rapids_tpu/kernels/pallas_ops.py`` (B1, B2), plus
the join probe, a kernel of the port alone, the direct-address probe
(the lookup of the reference's ``_prepare_direct``, which no Pallas kernel
does), and the string kernels of the port alone: SQL ``LIKE``
(``like_match``) and the casts between floats and strings
(``format_double``, ``parse_double``), which the reference runs in host
loops.  Each kernel
lives in ``csrc/`` as CUDA C++ with a plain C interface, is compiled at
first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the
repository root, and is loaded with ``ctypes``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, launches on the current CUDA stream, raises if the launch
failed and adds one to ``LAUNCHES[name]``.  A CPU tensor takes the plain
torch version beside it; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .aggregate import (CH_LANES, flip32, flip64, part_chunk_lanes,
                        unflip32)
from .basic import SIGN64, hash_to_partition, hash_words

_MASK32 = 0xFFFFFFFF

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {"hash_partition": "hash_partition.cu",
           "table_reduce": "table_reduce.cu",
           "join_probe": "join_probe.cu",
           "strings": "strings.cu",
           "numtext": "numtext.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper since the last ``reset_launches()``; the
#: table stage's launches that reduce a min kind, and a first or last
#: kind, are also counted apart
LAUNCHES: Dict[str, int] = {"hash_partition_ids": 0, "table_reduce": 0,
                            "table_reduce_min": 0,
                            "table_reduce_firstlast": 0, "join_probe": 0,
                            "direct_probe": 0, "like_match": 0,
                            "format_double": 0, "parse_double": 0}
_MAX_WORDS = 32

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: shared bytes one table_stage block may take, read once when its
#: library loads
_STAGE_BUDGET: List[int] = []
#: shared bytes one block may take and one SM has, read once when the
#: join probe's library loads
_PROBE_SMEM: List[int] = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- build ------------------------------------------------------------------

def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    """Build output for one source, named by a digest of the source, the
    headers beside it and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers +
                          " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Sequence[str] = None) -> Dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together.  Returns each library's ``-Xptxas -v`` report."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        rep = lib_path(name).with_suffix(".ptxas.txt")
        reports[name] = rep.read_text() if rep.exists() else ""
    return reports


class _Piece(ctypes.Structure):
    """``Piece`` of csrc/table_reduce.cu."""
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("emax", ctypes.c_void_p), ("kind", ctypes.c_int),
                ("lo", ctypes.c_int), ("hi", ctypes.c_int),
                ("g32", ctypes.c_int), ("g64", ctypes.c_int),
                ("smem", ctypes.c_int)]


class _Group(ctypes.Structure):
    _fields_ = [("first", ctypes.c_int), ("count", ctypes.c_int),
                ("bytes", ctypes.c_int)]


STAGE_MAX_PIECES = 48          # TS_MAX_PIECES
STAGE_MAX_GROUPS = 32          # TS_MAX_GROUPS
STAGE_GROUP_PIECES = 4         # TS_GROUP_PIECES (a raw column is one)


class _Plan(ctypes.Structure):
    _fields_ = [("piece", _Piece * STAGE_MAX_PIECES),
                ("group", _Group * STAGE_MAX_GROUPS),
                ("ngroups", ctypes.c_int), ("chunk", ctypes.c_int),
                ("stride", ctypes.c_int)]


#: most tokens of a LIKE pattern (LM_MAX_TOKENS); a byte is a token, and
#: ``_`` and ``%`` are LIKE_ONE and LIKE_ANY
LIKE_MAX_TOKENS = 512
LIKE_ONE, LIKE_ANY = 256, 257
#: most pieces of a pattern (LM_MAX_PIECES): runs of ``%`` are one token,
#: so a piece is at least one token
LIKE_MAX_PIECES = LIKE_MAX_TOKENS // 2 + 1


class _LikePattern(ctypes.Structure):
    """``LikePattern`` of csrc/strings.cu."""
    _fields_ = [("len", ctypes.c_int), ("pieces", ctypes.c_int),
                ("tok", ctypes.c_short * LIKE_MAX_TOKENS),
                ("start", ctypes.c_short * LIKE_MAX_PIECES),
                ("count", ctypes.c_short * LIKE_MAX_PIECES),
                ("fixed", ctypes.c_ubyte * LIKE_MAX_PIECES)]


_VP, _I, _LL, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint64)
_SIGNATURES = {
    "hash_partition": {
        "hash_partition_ids": [ctypes.POINTER(_VP), _I, _I, _I, _U64, _VP,
                               _VP],
        "hash_split": [ctypes.POINTER(_VP), _I, _VP, _I, _I, _U64, _I, _I,
                       _VP, _VP, _VP, _VP, _VP]},
    "table_reduce": {
        "table_stage": [_VP, _LL, _I, ctypes.POINTER(_Plan), _I, _VP, _VP,
                        _LL, _VP],
        "table_stage_smem_limit": []},
    "join_probe": {
        "join_probe": [_VP, _VP, _I, _I, _I, ctypes.POINTER(_VP), _VP, _I,
                       ctypes.c_uint, _VP, _VP, _I, _VP],
        "join_probe_smem": [_I],
        "direct_probe": [_VP, _I, _VP, _VP, _LL, _LL, _LL, _LL, _VP, _VP,
                         _LL, _LL, _LL, _VP, _VP, _I, _VP]},
    "strings": {
        "like_match": [_VP, _VP, _VP, _LL, ctypes.POINTER(_LikePattern),
                       _VP, _VP]},
    "numtext": {
        "format_double": [_VP, _I, _LL, _VP, _VP, _VP, _I, _VP],
        "parse_double": [_VP, _VP, _VP, _LL, _I, _VP, _VP, _VP, _I, _VP]},
}


def _load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            for fn, args in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            if name == "table_reduce":
                _STAGE_BUDGET.append(lib.table_stage_smem_limit())
            if name == "join_probe":
                _PROBE_SMEM.extend([lib.join_probe_smem(0),
                                    lib.join_probe_smem(1)])
            _LIBS[name] = lib
    return _LIBS[name]


def _raise_on(lib: ctypes.CDLL, what: str, err: int) -> None:
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _device_kind(tensors: Sequence[torch.Tensor], what: str) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: inputs on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type


def _check_contiguous(tensors: Sequence[torch.Tensor], what: str) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")


# -- B1: hash-partition ids, and the split by them --------------------------

#: most partitions ``hash_split`` takes (u16 ids; HS_MAX_PARTS)
SPLIT_MAX_PARTS = 4096


def _check_words(words: List[torch.Tensor], what: str) -> int:
    if not words or len(words) > _MAX_WORDS:
        raise ValueError(f"{what}: 1..{_MAX_WORDS} key words, got "
                         f"{len(words)}")
    n = words[0].shape[0]
    if any(w.dtype != torch.int64 or w.dim() != 1 or w.shape[0] != n
           for w in words):
        raise ValueError(f"{what}: words must be int64[n]")
    if n >= (1 << 31):
        raise ValueError(f"{what}: {n} rows exceed int32 indexing")
    _check_contiguous(words, what)
    return n


def _barrett_magic(num_parts: int) -> int:
    """floor((2^64 - 1) / num_parts): the kernels' fast modulo."""
    return ((1 << 64) - 1) // num_parts


def hash_partition_ids_plain(words: List[torch.Tensor],
                             num_parts: int) -> torch.Tensor:
    """Plain torch version of the hash-partition kernel."""
    return hash_to_partition(hash_words(words), num_parts)


def hash_partition_ids(words: List[torch.Tensor],
                       num_parts: int) -> torch.Tensor:
    """Partition id of every row: murmur-style mix over the 64-bit key
    words (int64 bit patterns), then unsigned ``% num_parts`` (a Barrett
    modulo on the card, bit-equal)."""
    what = "hash_partition_ids"
    n = _check_words(words, what)
    if not 0 < num_parts < (1 << 31):
        raise ValueError(f"{what}: num_parts {num_parts} out of range")
    if _device_kind(words, what) == "cpu":
        return hash_partition_ids_plain(words, num_parts)
    dev = words[0].device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _load("hash_partition")
    ptrs = (ctypes.c_void_p * len(words))(*[w.data_ptr() for w in words])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_partition_ids(ptrs, len(words), n, num_parts,
                                     _barrett_magic(num_parts),
                                     out.data_ptr(), stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return out


def split_tiles(n: int, num_parts: int):
    """(tiles, rows per tile) of ``hash_split``: about two tiles per SM of
    an H100 at large n, at least 2048 rows each, and few enough that the
    one-block scan of the [num_parts + 1, tiles] histogram stays under
    2^18 entries."""
    tiles = max(1, min(264, -(-n // 2048), (1 << 18) // (num_parts + 1)))
    tile = max(256, -(-n // tiles // 256) * 256)
    return max(1, -(-n // tile)), tile


def hash_split_plain(words: List[torch.Tensor], live: torch.Tensor,
                     num_parts: int):
    """Plain torch version of ``hash_split``: a stable sort of the ids
    (dead rows as ``num_parts``) and their counts."""
    pids = hash_partition_ids_plain(words, num_parts).to(torch.int64)
    key = torch.where(live, pids, num_parts)
    _, perm = torch.sort(key, stable=True)
    return perm, torch.bincount(key, minlength=num_parts + 1)


def hash_split(words: List[torch.Tensor], live: torch.Tensor,
               num_parts: int):
    """The exchange's split of a batch: (perm int64[n], counts
    int64[num_parts + 1]).  ``perm`` lists the live rows by partition id,
    each partition's rows in their input order, then the dead rows (live
    False) in theirs: what ``torch.sort(key, stable=True)`` gives for key =
    id, or ``num_parts`` for a dead row.  ``counts[p]`` is partition p's
    row count; the last entry counts the dead rows.  On the card, a
    counting sort in three launches (csrc/hash_partition.cu)."""
    what = "hash_split"
    n = _check_words(words, what)
    if not 0 < num_parts <= SPLIT_MAX_PARTS:
        raise ValueError(f"{what}: num_parts {num_parts} outside "
                         f"[1, {SPLIT_MAX_PARTS}]")
    if live.dtype != torch.bool or live.shape != (n,):
        raise ValueError(f"{what}: live must be bool[{n}]")
    _check_contiguous([live], what)
    if _device_kind([*words, live], what) == "cpu":
        return hash_split_plain(words, live, num_parts)
    dev = live.device
    tiles, tile = split_tiles(n, num_parts)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(num_parts + 1, dtype=torch.int64, device=dev)
    pid_ws = torch.empty(n, dtype=torch.int16, device=dev)
    hist_ws = torch.empty((num_parts + 1) * tiles, dtype=torch.int32,
                          device=dev)
    lib = _load("hash_partition")
    ptrs = (ctypes.c_void_p * len(words))(*[w.data_ptr() for w in words])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_split(ptrs, len(words), live.data_ptr(), n, num_parts,
                             _barrett_magic(num_parts), tiles, tile,
                             pid_ws.data_ptr(), hist_ws.data_ptr(),
                             perm.data_ptr(), counts.data_ptr(), stream)
    _raise_on(lib, what, err)
    LAUNCHES["hash_partition_ids"] += 1
    return perm, counts


# -- B2: the table core's reduce stage --------------------------------------

@dataclasses.dataclass(frozen=True)
class StageCol:
    """One input of ``table_stage``: a row kind, its column (None for a
    count of rows; a [k, n] matrix of k rows for a raw kind), the
    column's validity (None: every row valid) and, for ``fsum64``, the
    batch's largest f32 exponent as an int64 device scalar."""
    kind: str
    data: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    emax: Optional[torch.Tensor] = None


_KIND_IDS = {"count": 0, "icount": 1, "fsum64": 2, "fmax64": 3, "fsumv": 4,
             "fmax": 5, "sum32": 6, "sum64": 7, "max32": 8, "fmin64": 9,
             "fmin": 10, "first": 11, "last": 12}
#: bytes per bucket of each sub-row of a kind; a 64-bit one comes last.
#: A raw kind has one sub-row per row of its column.
_SUB_BYTES = {"count": (4,), "icount": (8,), "fsum64": (4,) * 19,
              "fmax64": (4, 4, 8), "fsumv": (4, 8), "fmax": (4, 4, 4),
              "sum32": (4,), "sum64": (8,), "max32": (4,),
              "fmin64": (4, 4, 8), "fmin": (4, 4, 4), "first": (4,),
              "last": (4,)}
_IN_DTYPE = {"count": None, "icount": torch.int64, "fsum64": torch.float64,
             "fmax64": torch.float64, "fsumv": torch.float64,
             "fmax": torch.float64, "sum32": torch.float32,
             "sum64": torch.float64, "max32": torch.float32,
             "fmin64": torch.float64, "fmin": torch.float64, "first": None,
             "last": None}
_RAW_KINDS = ("sum32", "sum64", "max32")


def sub_bytes(kind: str, rows: int = 1) -> Tuple[int, ...]:
    """Bytes per bucket of each sub-row of a column of this kind (``rows``:
    a raw column's row count)."""
    return _SUB_BYTES[kind] * (rows if kind in _RAW_KINDS else 1)


def _shape(c: StageCol) -> Tuple[str, int]:
    return c.kind, (c.data.shape[0] if c.kind in _RAW_KINDS else 1)


@dataclasses.dataclass
class StagePlan:
    """How ``table_stage`` lays its tables out.  ``rows[c]`` is column c's
    first u32 and u64 output row; each group is the pieces ``(column,
    lo, hi, shared byte offset)`` one y-block reduces; ``chunk`` buckets
    per y-block, ``stride`` shared slots per sub-row."""
    rows: List[Tuple[int, int]]
    groups: List[List[Tuple[int, int, int, int]]]
    group_bytes: List[int]
    chunk: int
    stride: int
    r32: int
    r64: int


def stage_plan(shapes: Sequence[Tuple[str, int]], table: int,
               budget: int) -> StagePlan:
    """Pack the sub-rows of the columns, each a (kind, rows) pair, into
    groups whose shared tables fit ``budget`` bytes, about equal in size,
    each of at most STAGE_GROUP_PIECES columns; tables past the budget
    split their bucket range too."""
    subs_of = [sub_bytes(k, r) for k, r in shapes]
    rows, g32, g64 = [], 0, 0
    for sb in subs_of:
        rows.append((g32, g64))
        g32 += sb.count(4)
        g64 += sb.count(8)
    chunk = table if 8 * (table + table % 2) <= budget else (budget // 8) & ~1
    stride = chunk + chunk % 2
    subs = [(c, j, b * stride) for c, sb in enumerate(subs_of)
            for j, b in enumerate(sb)]
    total = sum(s[2] for s in subs)
    target = total / -(-total // budget)
    groups, sizes, used = [[]], [0], 0
    for c, j, nb in subs:
        cur = groups[-1]
        new_piece = not cur or cur[-1][0] != c
        if cur and (used + nb > budget or used + nb / 2 > target or
                    (new_piece and len(cur) == STAGE_GROUP_PIECES)):
            groups.append([])
            sizes.append(0)
            cur, used, new_piece = groups[-1], 0, True
        if new_piece:
            cur.append((c, j, j + 1, used))
        else:
            col, lo, _, off = cur[-1]
            cur[-1] = (col, lo, j + 1, off)
        used += nb
        sizes[-1] = used
    if len(groups) > STAGE_MAX_GROUPS or \
            sum(map(len, groups)) > STAGE_MAX_PIECES:
        raise ValueError(f"table_stage: {len(shapes)} columns at table "
                         f"{table} need more than {STAGE_MAX_GROUPS} groups "
                         f"or {STAGE_MAX_PIECES} pieces")
    return StagePlan(rows, groups, sizes, chunk, stride, g32, g64)


def decode_max32(key: torch.Tensor) -> torch.Tensor:
    """f32 max words (flip32 order, 0 = empty) -> f32, empty -> -inf."""
    return torch.where(key == 0, float("-inf"), unflip32(key))


def decode_min32(key: torch.Tensor) -> torch.Tensor:
    """Complemented f32 max words (0 = empty) -> the f32 min, empty ->
    +inf."""
    w = key.to(torch.int64) & _MASK32
    return torch.where(w == 0, float("inf"), unflip32(~w & _MASK32))


def decode_position(kind: str, key: torch.Tensor) -> torch.Tensor:
    """``first`` / ``last`` position words (u32, 0 = no row) -> the row
    position as int64, -1 for none."""
    w = key.to(torch.int64) & _MASK32
    if kind == "first":
        return torch.where(w == 0, -1, ~w & _MASK32)
    return w - 1


def position_words(kind: str, n: int, ok: torch.Tensor) -> torch.Tensor:
    """The u32 words (in int64) ``first`` / ``last`` max per bucket: the
    row's complemented position, or its position + 1; 0 where not
    ``ok``."""
    pos = torch.arange(n, dtype=torch.int64, device=ok.device)
    w = ~pos & _MASK32 if kind == "first" else pos + 1
    return torch.where(ok, w, 0)


def table_stage_plain(bucket: torch.Tensor, table: int,
                      cols: Sequence[StageCol]) -> List[tuple]:
    """Plain torch version of ``table_stage``: index_add_ for the counts
    and sums, the chunk lanes of ``part_chunk_lanes``, and scatter_reduce_
    for the max words (a min's complemented, a first's or last's the
    position words)."""
    b = torch.where((bucket >= 0) & (bucket < table), bucket,
                    table).to(torch.int64)

    def tab(vals, dtype, reduce="sum", init=0):
        out = torch.full((table + 1,), init, dtype=dtype,
                         device=bucket.device)
        if reduce == "sum":
            out.index_add_(0, b, vals.to(dtype))
        else:
            out.scatter_reduce_(0, b, vals.to(dtype), "amax",
                                include_self=True)
        return out[:table]

    res = []
    for c in cols:
        k, v = c.kind, c.data
        if k == "sum32" or k == "sum64":
            out = torch.zeros(v.shape[0], table + 1, dtype=v.dtype,
                              device=v.device).index_add_(1, b, v)
            res.append((out[:, :table],))
            continue
        if k == "max32":
            key = flip32(torch.where(torch.isnan(v), float("nan"), v))
            out = torch.zeros(v.shape[0], table + 1, dtype=torch.int64,
                              device=v.device).scatter_reduce_(
                1, b.expand_as(key), key, "amax", include_self=True)
            res.append((decode_max32(out[:, :table]),))
            continue
        ok = c.valid if c.valid is not None else \
            torch.ones_like(b, dtype=torch.bool)
        if k in ("first", "last"):
            w = tab(position_words(k, b.shape[0], ok), torch.int64, "amax")
            res.append((decode_position(k, w),))
            continue
        cnt = tab(ok, torch.int32)
        if k == "count":
            res.append((cnt,))
        elif k == "icount":
            res.append((tab(torch.where(ok, v, 0), torch.int64),))
        elif k == "fsumv":
            res.append((cnt, tab(torch.where(ok, v, 0.0), torch.float64)))
        elif k == "fsum64":
            okf = ok & torch.isfinite(v)
            vq = torch.where(okf, v, 0.0)
            hi = vq.to(torch.float32)
            lo = (vq - hi.to(torch.float64)).to(torch.float32)
            lanes = torch.zeros(v.shape[0], CH_LANES, dtype=torch.int32,
                                device=v.device)
            part_chunk_lanes(hi, okf, c.emax, lanes)
            part_chunk_lanes(lo, okf, c.emax, lanes)
            lane_tab = torch.zeros(table + 1, CH_LANES, dtype=torch.int32,
                                   device=v.device).index_add_(0, b, lanes)
            res.append((cnt, tab(ok & torch.isnan(v), torch.int32),
                        tab(ok & (v == float("inf")), torch.int32),
                        tab(ok & (v == float("-inf")), torch.int32),
                        lane_tab[:table].T.contiguous()))
        else:                              # fmax64, fmax, fmin64, fmin
            v = torch.where(v == 0.0, 0.0, v)        # -0.0 == 0.0
            okn = ok & ~torch.isnan(v)
            nn = tab(okn, torch.int32)
            if k in ("fmax", "fmin"):
                key = flip32(v.to(torch.float32))
                if k == "fmin":
                    key = ~key & _MASK32
                key = tab(torch.where(okn, key, 0), torch.int64, "amax")
                res.append((cnt, nn, decode_max32(key) if k == "fmax"
                            else decode_min32(key)))
                continue
            # the u64 word flip64(v) (complemented for a min) as int64
            # bits, maxed as a signed max with the top bit flipped
            key = flip64(v) if k == "fmax64" else ~flip64(v)
            w = tab(torch.where(okn, key ^ SIGN64, SIGN64),
                    torch.int64, "amax", SIGN64)
            res.append((cnt, nn, w ^ SIGN64))
    return res


def _check_stage(bucket: torch.Tensor, table: int,
                 cols: Sequence[StageCol], what: str) -> List[torch.Tensor]:
    if bucket.dtype != torch.int32 or bucket.dim() != 1:
        raise ValueError(f"{what}: bucket must be int32[n]")
    n = bucket.shape[0]
    if not 0 < table < (1 << 24):
        raise ValueError(f"{what}: table {table} out of range")
    if n >= (1 << 31):
        raise ValueError(f"{what}: {n} rows exceed int32 indexing")
    tensors = [bucket]
    for c in cols:
        if c.kind not in _KIND_IDS:
            raise ValueError(f"{what}: unknown kind {c.kind!r}")
        want = _IN_DTYPE[c.kind]
        raw = c.kind in _RAW_KINDS
        if (want is None) != (c.data is None) or (
                c.data is not None and (
                    c.data.dtype != want or c.data.shape[-1:] != (n,) or
                    c.data.dim() != 1 + raw or
                    (raw and c.data.shape[0] < 1))):
            raise ValueError(f"{what}: {c.kind} takes "
                             f"{'no column' if want is None else want}"
                             f"{'[rows, ' if raw else '['}{n}]")
        if c.valid is not None and (c.valid.dtype != torch.bool or
                                    c.valid.shape != (n,) or
                                    c.kind in _RAW_KINDS):
            raise ValueError(f"{what}: {c.kind} validity must be bool[{n}]")
        if (c.kind == "fsum64") != (c.emax is not None) or (
                c.emax is not None and (c.emax.dtype != torch.int64 or
                                        c.emax.numel() != 1)):
            raise ValueError(f"{what}: fsum64, and only it, takes an int64 "
                             f"emax scalar")
        tensors += [t for t in (c.data, c.valid, c.emax) if t is not None]
    if 0 < sum(c.kind in _RAW_KINDS for c in cols) < len(cols):
        raise ValueError(f"{what}: raw row kinds do not mix with the "
                         f"others in one call")
    _check_contiguous(tensors, what)
    return tensors


_PLANS: Dict[tuple, Tuple[StagePlan, _Plan]] = {}


def _stage_ctypes(shapes: Tuple[Tuple[str, int], ...], table: int,
                  budget: int):
    """The plan of these columns and its ctypes form without column
    pointers, built once per (shapes, table, budget)."""
    key = (shapes, table, budget)
    if key not in _PLANS:
        sp = stage_plan(shapes, table, budget)
        cp = _Plan()
        i = 0
        for gi, (pieces, nbytes) in enumerate(zip(sp.groups,
                                                  sp.group_bytes)):
            cp.group[gi] = _Group(i, len(pieces), nbytes)
            for col, lo, hi, off in pieces:
                g32, g64 = sp.rows[col]
                cp.piece[i] = _Piece(None, None, None,
                                     _KIND_IDS[shapes[col][0]], lo, hi, g32,
                                     g64, off)
                i += 1
        cp.ngroups, cp.chunk, cp.stride = len(sp.groups), sp.chunk, sp.stride
        _PLANS[key] = (sp, cp)
    return _PLANS[key]


def table_stage(bucket: torch.Tensor, table: int,
                cols: Sequence[StageCol]) -> List[tuple]:
    """The reduce stage of the table core: every column's per-bucket
    tables, in one launch on the card.  Rows whose bucket lies outside
    [0, table) (the dead slot) are dropped.  Per column, by kind:

    - count:  (count int32,)
    - icount: (sum int64,)
    - fsum64: (count, NaN count, +inf count, -inf count int32,
      chunk lanes int32[CH_LANES, table])
    - fmax64: (count, non-NaN count int32, u64 max word as int64 bits)
    - fmin64: (count, non-NaN count int32, u64 max of the complemented
      word as int64 bits: ``unflip64(~w)`` is the min)
    - fsumv:  (count int32, sum float64)
    - fmax:   (count, non-NaN count int32, max float32)
    - fmin:   (count, non-NaN count int32, min float32; empty +inf)
    - first / last, no column (valid: the rows that count, None for
      every row): (row position int64, -1 for none)
    - sum32 / sum64 / max32, a [k, n] column: (float32 / float64 sums
      [k, table],) / (float32 maxes [k, table],)

    An empty bucket has zeros, a max word of 0, and a float max of -inf;
    a NaN wins a raw max32 row.  Raw kinds go in a call of their own."""
    what = "table_stage"
    tensors = _check_stage(bucket, table, cols, what)
    if _device_kind(tensors, what) == "cpu":
        return table_stage_plain(bucket, table, cols)
    dev = bucket.device
    lib = _load("table_reduce")
    sp, cached = _stage_ctypes(tuple(map(_shape, cols)), table,
                               _STAGE_BUDGET[0])
    cp = _Plan.from_buffer_copy(cached)      # this call's column pointers
    i = 0
    for pieces in sp.groups:
        for col, *_ in pieces:
            c = cols[col]
            p = cp.piece[i]
            p.data = c.data.data_ptr() if c.data is not None else None
            p.valid = c.valid.data_ptr() if c.valid is not None else None
            p.emax = c.emax.data_ptr() if c.emax is not None else None
            i += 1
    n64, n32 = sp.r64 * table, sp.r32 * table
    out = torch.empty(n64 + (n32 + 1) // 2, dtype=torch.int64, device=dev)
    out64 = out[:n64].view(sp.r64, table)
    out32 = out[n64:].view(torch.int32)[:n32].view(sp.r32, table)
    # vector loads take 16-byte aligned columns and 4-byte aligned masks;
    # the rows of a raw column start every n elements
    loaded = [bucket] + [t for c in cols for t in (c.data, c.valid)
                         if t is not None]
    aligned = all(t.data_ptr() % (4 if t.dtype == torch.bool else 16) == 0
                  for t in loaded)
    rows_aligned = bucket.shape[0] % 4 == 0 or \
        all(_shape(c)[1] == 1 for c in cols)
    vec = 4 if aligned and rows_aligned else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.table_stage(bucket.data_ptr(), bucket.shape[0], table,
                              ctypes.byref(cp), vec, out.data_ptr(),
                              out.data_ptr() + n64 * 8,
                              out.numel() * 8, stream)
    _raise_on(lib, what, err)
    LAUNCHES["table_reduce"] += 1
    kinds = {c.kind for c in cols}
    LAUNCHES["table_reduce_min"] += bool(kinds & {"fmin64", "fmin"})
    LAUNCHES["table_reduce_firstlast"] += bool(kinds & {"first", "last"})
    res = []
    for c, (g32, g64) in zip(cols, sp.rows):
        sb = sub_bytes(*_shape(c))
        r32 = out32[g32:g32 + sb.count(4)]
        r64 = out64[g64:g64 + sb.count(8)]
        res.append(_kernel_outputs(c.kind, r32, r64))
    return res


def _kernel_outputs(kind: str, r32: torch.Tensor, r64: torch.Tensor):
    """One column's tables from the kernel's output rows, as
    ``table_stage_plain`` returns them."""
    if kind == "count":
        return (r32[0],)
    if kind == "icount":
        return (r64[0],)
    if kind == "fsum64":
        return (r32[0], r32[1], r32[2], r32[3], r32[4:])
    if kind in ("fmax64", "fmin64"):
        return (r32[0], r32[1], r64[0])
    if kind == "fmin":
        return (r32[0], r32[1], decode_min32(r32[2]))
    if kind in ("first", "last"):
        return (decode_position(kind, r32[0]),)
    if kind == "fsumv":
        return (r32[0], r64[0].view(torch.float64))
    if kind == "fmax":
        return (r32[0], r32[1], decode_max32(r32[2]))
    if kind == "sum32":
        return (r32.view(torch.float32),)
    if kind == "sum64":
        return (r64.view(torch.float64),)
    return (decode_max32(r32),)                      # max32


def table_reduce_plain(bucket: torch.Tensor, sums: torch.Tensor,
                       maxs: torch.Tensor, table: int):
    """Plain torch version of ``table_reduce``."""
    return _raw_rows(table_stage_plain, bucket, sums, maxs, table)


def table_reduce(bucket: torch.Tensor, sums: torch.Tensor,
                 maxs: torch.Tensor, table: int):
    """The TPU kernel's function, on ``table_stage``'s raw row kinds:
    reduce rows into ``table`` buckets; the dead slot ``table`` (and any
    id outside [0, table)) is dropped.

    bucket: int32[n]; sums: f32 or f64 [k, n]; maxs: f32[m, n] (mins
    ride negated).  Returns (sums' dtype [k, table] sums, f32[m, table]
    maxes); empty buckets are 0 and -inf, and a NaN wins its bucket's
    max."""
    what = "table_reduce"
    n = bucket.shape[0]
    for t, nm, dts in ((sums, "sums", (torch.float32, torch.float64)),
                       (maxs, "maxs", (torch.float32,))):
        if t.dtype not in dts or t.dim() != 2 or t.shape[1] != n:
            raise ValueError(f"{what}: {nm} must be "
                             f"{'/'.join(map(str, dts))}[rows, {n}]")
    _check_contiguous([sums, maxs], what)
    return _raw_rows(table_stage, bucket, sums, maxs, table)


def _raw_rows(stage, bucket, sums, maxs, table):
    """The sum rows as one raw column and the max rows as another."""
    kind = "sum64" if sums.dtype == torch.float64 else "sum32"
    mats = [(kind, sums), ("max32", maxs)]
    cols = [StageCol(k, m) for k, m in mats if m.shape[0]]
    out = iter(stage(bucket, table, cols) if cols else [])
    return tuple(next(out)[0] if m.shape[0] else
                 torch.empty(0, table, dtype=m.dtype, device=bucket.device)
                 for _, m in mats)


# -- the join probe (a kernel of the port alone) ----------------------------

#: threads per block of the join probe, and the separator tables one SM
#: holds (each block's budget is the SM's share): the fastest of 256-1024
#: threads and 1, 2 or 4 tables at q17's join and the customer star
#: (chip_smoke.probe_tradeoff, PERF.md)
PROBE_THREADS = 1024
PROBE_TABLES_PER_SM = 1
#: shared bytes the runtime keeps for each block
_BLOCK_RESERVE = 1024


@dataclasses.dataclass
class ProbeIndex:
    """The join probe's index of a sorted build side (csrc/join_probe.cu):
    the sorted key words row-major, padded with a zero word to an even
    count (16-byte rows), and the separators, every ``stride``-th row, that
    one block holds in shared memory.  ``threads``: the probe's block."""
    rows: torch.Tensor      # int64[build_n, kp]
    seps: torch.Tensor      # int64[ceil(build_n / stride), kp]
    stride: int
    words: int
    threads: int = PROBE_THREADS


def probe_budget(tables_per_sm: int = PROBE_TABLES_PER_SM) -> int:
    """Shared bytes of one separator table when an SM holds
    ``tables_per_sm`` of them (read from the card)."""
    _load("join_probe")
    optin, per_sm = _PROBE_SMEM
    return min(optin, per_sm // tables_per_sm - _BLOCK_RESERVE)


def probe_stride(build_n: int, words: int, budget: int) -> int:
    """The least power of two for which every ``stride``-th row of a build
    of ``build_n`` rows of ``words`` words (padded to even) fits
    ``budget`` bytes."""
    row = 8 * (words + (words & 1))
    if budget < row:
        raise ValueError(f"probe_stride: {budget} bytes hold no {row}-byte "
                         f"row")
    stride = 1
    while -(-build_n // stride) * row > budget:
        stride *= 2
    return stride


def probe_index(sorted_words: List[torch.Tensor], budget: int = None,
                threads: int = PROBE_THREADS) -> ProbeIndex:
    """The probe's index of sorted build words, made once per build (on
    the card, ``budget`` defaults to ``probe_budget()``)."""
    k = len(sorted_words)
    pad = [torch.zeros_like(sorted_words[0])] if k & 1 else []
    rows = torch.stack([*sorted_words, *pad], dim=1)
    if budget is None:
        budget = probe_budget()
    stride = probe_stride(rows.shape[0], k, budget)
    return ProbeIndex(rows, rows[::stride].contiguous(), stride, k, threads)


def join_probe_plain(build_words: List[torch.Tensor],
                     probe_words: List[torch.Tensor], live: torch.Tensor,
                     rank_words: Sequence[int]):
    """Plain torch version of ``join_probe``: the bounds of
    ``kernels/join.bounds``, a stable merge of build and probe words."""
    from .join import bounds
    lo, hi = bounds(build_words, probe_words)
    usable = live
    for i in rank_words:
        usable = usable & (probe_words[i] == 1)
    return lo, torch.where(usable, hi - lo, 0)


def join_probe(build_words: List[torch.Tensor],
               probe_words: List[torch.Tensor], live: torch.Tensor,
               rank_words: Sequence[int], index: ProbeIndex = None):
    """Each probe row's matches in the sorted build side: (lo int64[n],
    the first build row not less than the row's words, unsigned
    lexicographic; counts int64[n], the build rows equal to them, or 0
    for a dead row or one whose rank word at any of ``rank_words`` is not
    1, a null key).  On the card, one launch (csrc/join_probe.cu) over
    ``index``, the build words' ``probe_index`` (made here if None)."""
    what = "join_probe"
    n = _check_words(probe_words, what)
    bn = _check_words(build_words, what)
    k = len(probe_words)
    if len(build_words) != k:
        raise ValueError(f"{what}: {len(build_words)} build words against "
                         f"{k} probe words")
    if live.dtype != torch.bool or live.shape != (n,):
        raise ValueError(f"{what}: live must be bool[{n}]")
    if any(not 0 <= i < k for i in rank_words):
        raise ValueError(f"{what}: rank word positions {list(rank_words)} "
                         f"out of range")
    _check_contiguous([live], what)
    if _device_kind([*build_words, *probe_words, live], what) == "cpu":
        return join_probe_plain(build_words, probe_words, live, rank_words)
    if index is None:
        index = probe_index(build_words)
    kp = k + (k & 1)
    stride = index.stride
    if (index.words != k or index.rows.shape != (bn, kp) or
            index.seps.shape != (-(-bn // stride), kp) or
            stride & (stride - 1) or
            any(t.device != live.device or t.dtype != torch.int64 or
                not t.is_contiguous() or t.data_ptr() % 16
                for t in (index.rows, index.seps))):
        raise ValueError(f"{what}: the index is not one of these build "
                         f"words")
    dev = live.device
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    lib = _load("join_probe")
    pptrs = (ctypes.c_void_p * k)(*[w.data_ptr() for w in probe_words])
    mask = 0
    for i in rank_words:
        mask |= 1 << i
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.join_probe(index.rows.data_ptr(), index.seps.data_ptr(), k,
                             bn, stride.bit_length() - 1, pptrs,
                             live.data_ptr(), n, mask, lo.data_ptr(),
                             counts.data_ptr(), index.threads, stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return lo, counts


# -- the direct-address probe -------------------------------------------------

#: threads of a direct_probe block
DIRECT_THREADS = 256


def direct_probe_plain(keys: torch.Tensor, valid: torch.Tensor, rows,
                       smin: int, smax: int, hist: torch.Tensor,
                       excl: torch.Tensor, nnull: int, nvalid: int):
    """Plain torch version of ``direct_probe``."""
    live = torch.arange(keys.shape[0], device=keys.device) < rows
    v = keys.to(torch.int64)
    ok = valid & live
    hit = ok & (v >= smin) & (v <= smax)
    idx = torch.where(hit, v - smin, 0)
    counts = torch.where(hit, hist[idx].to(torch.int64), 0)
    miss = torch.where(live & ~valid, 0, torch.where(
        ok & (v < smin), nnull, nnull + nvalid))
    return torch.where(hit, excl[idx].to(torch.int64), miss), counts


def direct_probe(keys: torch.Tensor, valid: torch.Tensor, rows,
                 smin: int, smax: int, hist: torch.Tensor,
                 excl: torch.Tensor, nnull: int, nvalid: int):
    """Each probe row's matches by direct address (``kernels/join.
    direct_tables``): (lo int64[n], counts int64[n]) equal to
    ``join_probe``'s over the same build.  ``keys`` is the stream key
    column's data (int32 or int64, signed values), ``valid`` its validity
    (bool[n]), ``rows`` its live rows (an int or a device count; rows at
    or past it are dead); ``smin`` and ``smax`` the build's least and
    greatest valid key; ``hist`` and ``excl`` int32 over at least
    ``smax - smin + 1`` slots; ``nnull`` and ``nvalid`` the build's null
    and valid rows.  On the card, one launch (csrc/join_probe.cu
    ``direct_probe``), which reads the live count where it lies."""
    what = "direct_probe"
    n = keys.shape[0]
    slots = hist.shape[0]
    if (keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1 or
            valid.dtype != torch.bool or valid.shape != keys.shape):
        raise ValueError(f"{what}: keys must be int32 or int64[n] and "
                         f"valid bool[n]")
    if n >= (1 << 31):
        raise ValueError(f"{what}: {n} rows exceed int32 indexing")
    if (hist.dtype != torch.int32 or excl.dtype != torch.int32 or
            hist.dim() != 1 or excl.shape != hist.shape or
            not smin <= smax or smax - smin >= slots):
        raise ValueError(f"{what}: tables must be int32[slots] with slots > "
                         f"smax - smin")
    counted = [keys, valid, hist, excl] + (
        [rows] if isinstance(rows, torch.Tensor) else [])
    _check_contiguous(counted, what)
    if _device_kind(counted, what) == "cpu":
        return direct_probe_plain(keys, valid, rows, smin, smax, hist, excl,
                                  nnull, nvalid)
    dev = keys.device
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    if isinstance(rows, torch.Tensor):
        rows_dev, rows_host = rows.reshape(()).to(torch.int64), 0
        rows_ptr = rows_dev.data_ptr()
    else:
        rows_ptr, rows_host = None, int(rows)
    lib = _load("join_probe")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.direct_probe(keys.data_ptr(), keys.element_size(),
                               valid.data_ptr(), rows_ptr, rows_host, n,
                               smin, smax, hist.data_ptr(), excl.data_ptr(),
                               slots, nnull, nvalid, lo.data_ptr(),
                               counts.data_ptr(), DIRECT_THREADS, stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return lo, counts


# -- SQL LIKE ------------------------------------------------------------------

#: threads of a format_double and parse_double block
TEXT_THREADS = 256
#: rows of one like_match tile and the bytes its window stages
#: (LM_THREADS and LM_BUDGET of csrc/strings.cu)
LIKE_TILE_ROWS = 256
LIKE_TILE_BYTES = LIKE_TILE_ROWS * 70


def like_tokens(pattern: str, escape: str = "\\") -> List[int]:
    """A LIKE pattern as ``like_match``'s tokens: each byte of its UTF-8
    text, LIKE_ONE for ``_`` and LIKE_ANY for ``%`` (runs of ``%`` kept
    as one); the escape character makes the next character literal.  A
    pattern that ends with the escape raises ``ValueError``, as Spark's
    does."""
    out: List[int] = []
    chars = iter(pattern)
    for ch in chars:
        if escape and ch == escape:
            nxt = next(chars, None)
            if nxt is None:
                raise ValueError(f"LIKE {pattern!r} ends with its escape "
                                 f"character")
            out.extend(nxt.encode("utf-8"))
        elif ch == "%":
            if not out or out[-1] != LIKE_ANY:
                out.append(LIKE_ANY)
        elif ch == "_":
            out.append(LIKE_ONE)
        else:
            out.extend(ch.encode("utf-8"))
    return out


def like_pieces(tokens: Sequence[int]):
    """The pattern ``tokens`` cut at its ``%``s, as ``like_match``'s kernel
    reads it: (start, count, fixed) of each piece, the first anchored at
    the row's start and the last at its end (an empty last piece: the
    pattern ends with ``%``; an empty first one: it starts with one).
    ``start`` is the piece's first token, ``count`` its tokens and
    ``fixed`` whether none is LIKE_ONE (its bytes are its length)."""
    pieces, start = [], 0
    for k, t in enumerate(list(tokens) + [LIKE_ANY]):
        if t == LIKE_ANY:
            piece = tokens[start:k]
            pieces.append((start, k - start, LIKE_ONE not in piece))
            start = k + 1
    return pieces


def _like_pattern(tokens: Sequence[int]) -> _LikePattern:
    pat = _LikePattern()
    pat.len = len(tokens)
    for k, t in enumerate(tokens):
        pat.tok[k] = t
    pieces = like_pieces(tokens)
    pat.pieces = len(pieces)
    for j, (start, count, fixed) in enumerate(pieces):
        pat.start[j], pat.count[j], pat.fixed[j] = start, count, fixed
    return pat


def _char_bytes(b: torch.Tensor) -> torch.Tensor:
    """Bytes of the UTF-8 character a lead byte starts (1 for a stray
    continuation byte), as the kernel counts them."""
    return torch.where(b < 0xC0, 1, torch.where(b < 0xE0, 2, torch.where(
        b < 0xF0, 3, 4)))


def like_match_plain(offsets: torch.Tensor, data: torch.Tensor,
                     valid: torch.Tensor, tokens: Sequence[int]
                     ) -> torch.Tensor:
    """Plain torch version of ``like_match``: the kernel's greedy match,
    one step of every row at a time."""
    dev = valid.device
    n = valid.shape[0]
    i = offsets[:-1].to(torch.int64)
    e = offsets[1:].to(torch.int64)
    plen = len(tokens)
    tok = torch.tensor(list(tokens) + [-1], dtype=torch.int64, device=dev)
    p = torch.zeros(n, dtype=torch.int64, device=dev)
    star = torch.full((n,), -1, dtype=torch.int64, device=dev)
    mark = torch.zeros(n, dtype=torch.int64, device=dev)
    ok = valid.clone()
    active = ok & (i < e)
    last = max(data.shape[0] - 1, 0)
    while bool(active.any()):
        t = tok[p]
        byte = data[i.clamp(0, last)].to(torch.int64)
        one = active & (t == LIKE_ONE)
        lit = active & (t >= 0) & (t < LIKE_ONE) & (byte == t)
        any_ = active & (t == LIKE_ANY)
        rest = active & ~one & ~lit & ~any_
        back = rest & (star >= 0)
        ok = ok & ~(rest & (star < 0))
        moved = torch.minimum(
            mark + _char_bytes(data[mark.clamp(0, last)].to(torch.int64)), e)
        i = torch.where(one, torch.minimum(i + _char_bytes(byte), e),
                        torch.where(lit, i + 1, torch.where(back, moved, i)))
        mark = torch.where(any_, i, torch.where(back, moved, mark))
        star = torch.where(any_, p, star)
        p = torch.where(one | lit | any_, p + 1,
                        torch.where(back, star + 1, p))
        active = active & ok & (i < e)
    for _ in range(plen):
        p = torch.where(ok & (tok[p] == LIKE_ANY), p + 1, p)
    return ok & (p == plen)


def like_match(offsets: torch.Tensor, data: torch.Tensor,
               valid: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """bool[n]: row i (bytes ``[offsets[i], offsets[i + 1])`` of
    ``data``) matches the LIKE pattern ``tokens`` (``like_tokens``);
    False for a null row.  On the card, one launch (csrc/strings.cu) over
    tiles of rows staged in shared memory, the pattern and its pieces
    (``like_pieces``) passed by value."""
    what = "like_match"
    n = valid.shape[0]
    if (offsets.dtype != torch.int32 or offsets.shape != (n + 1,) or
            data.dtype != torch.uint8 or valid.dtype != torch.bool):
        raise ValueError(f"{what}: offsets int32[n + 1], data uint8 and "
                         f"valid bool[n]")
    if len(tokens) > LIKE_MAX_TOKENS:
        raise ValueError(f"{what}: a pattern of {len(tokens)} tokens (at "
                         f"most {LIKE_MAX_TOKENS})")
    _check_contiguous([offsets, data, valid], what)
    if _device_kind([offsets, data, valid], what) == "cpu":
        return like_match_plain(offsets, data, valid, tokens)
    if data.untyped_storage().data_ptr() % 16:
        # the kernel copies whole 16-byte words around each tile's bytes
        raise ValueError(f"{what}: the bytes' storage must start at a "
                         f"16-byte boundary")
    dev = valid.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    pat = _like_pattern(tokens)
    lib = _load("strings")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.like_match(offsets.data_ptr(), data.data_ptr(),
                             valid.data_ptr(), n, ctypes.byref(pat),
                             out.data_ptr(), stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return out


# -- floats to digits and strings to floats ------------------------------------

#: decimal exponents of the power-of-ten table (NT_POW10_MIN, NT_POW10_MAX)
POW10_MIN, POW10_MAX = -350, 350
_POW10: Dict[str, torch.Tensor] = {}


def pow10_significands() -> List[int]:
    """g(e) for e in [POW10_MIN, POW10_MAX]: the 128-bit significand of
    10^e in [2^127, 2^128), rounded up unless it is exact (Schubfach's
    table), from Python's integers."""
    out = []
    for e in range(POW10_MIN, POW10_MAX + 1):
        if e >= 0:
            v = 10 ** e
            s = v.bit_length() - 128
            g = v << -s if s <= 0 else (v >> s) + (v & ((1 << s) - 1) != 0)
        else:
            d = 10 ** -e
            s = d.bit_length() + 127
            g = (1 << s) // d
            if g >= 1 << 128:
                g = (1 << (s - 1)) // d
            g += 1
        out.append(g)
    return out


def pow10_table(device) -> torch.Tensor:
    """``pow10_significands`` as int64[entries, 2] (low word, high word;
    bit patterns), built at first use and uploaded once per device."""
    key = str(device)
    t = _POW10.get(key)
    if t is None:
        words = []
        for g in pow10_significands():
            for w in (g & ((1 << 64) - 1), g >> 64):
                words.append(w - (1 << 64) if w >> 63 else w)
        t = torch.tensor(words, dtype=torch.int64).reshape(-1, 2).to(device)
        _POW10[key] = t
    return t


def _repr_digits(text: str):
    """(digits, exp10) of a shortest repr ``[-]d[.ddd][e±n]``, trailing
    zeros stripped."""
    text = text.lstrip("-")
    mant, _, ex = text.partition("e")
    whole, _, frac = mant.partition(".")
    d = int((whole + frac).lstrip("0") or "0")
    e = int(ex or 0) - len(frac)
    while d and d % 10 == 0:
        d //= 10
        e += 1
    return d, e


def format_double_plain(x: torch.Tensor):
    """Plain version of ``format_double``: the digits of Python's
    ``float.__repr__`` (numpy's shortest ``float32`` repr for a float
    column), which defines the shortest digits that read back to the same
    value and the closest of them.  A host loop over the rows, for the
    CPU alone: it never runs when a card is present."""
    import numpy as np
    vals = x.cpu().numpy()
    digits, exps = [], []
    for v in vals:
        if not np.isfinite(v) or v == 0:
            d, e = 0, 0
        elif vals.dtype == np.float32:
            d, e = _repr_digits(np.format_float_scientific(
                v, unique=True, trim="-").replace("e+", "e"))
        else:
            d, e = _repr_digits(repr(float(v)))
        digits.append(d)
        exps.append(e)
    return (torch.tensor(digits, dtype=torch.int64, device=x.device),
            torch.tensor(exps, dtype=torch.int32, device=x.device))


def format_double(x: torch.Tensor):
    """(digits int64[n], exp10 int32[n]) of a float64 or float32 column:
    the shortest decimal digits that read back to the same value (the
    closest of them), trailing zeros stripped, with |x| = digits *
    10^exp10; (0, 0) for 0, NaN and the infinities.  On the card, one
    launch (csrc/numtext.cu, Schubfach over ``pow10_table``)."""
    what = "format_double"
    if x.dtype not in (torch.float64, torch.float32) or x.dim() != 1:
        raise ValueError(f"{what}: x must be float64[n] or float32[n]")
    _check_contiguous([x], what)
    if _device_kind([x], what) == "cpu":
        return format_double_plain(x)
    dev = x.device
    n = x.shape[0]
    digits = torch.empty(n, dtype=torch.int64, device=dev)
    exp10 = torch.empty(n, dtype=torch.int32, device=dev)
    table = pow10_table(dev)
    lib = _load("numtext")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.format_double(x.data_ptr(), int(x.dtype == torch.float32),
                                n, table.data_ptr(), digits.data_ptr(),
                                exp10.data_ptr(), TEXT_THREADS, stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return digits, exp10


#: the text ``parse_double`` reads as a number, after the bytes <= 0x20 at
#: either end are trimmed: Java's decimal ``Double.parseDouble`` (digits
#: with an optional point, an exponent and a d/D/f/F suffix) and the words
#: NaN, Inf and Infinity in any case (Spark's special literals), each with
#: an optional sign
FLOAT_TEXT = re.compile(rb"([+-]?)(?:(nan|inf|infinity)|((?:\d+\.?\d*|\.\d+)"
                        rb"(?:[eE][+-]?\d+)?)[dDfF]?)", re.IGNORECASE)


def _float32_of(text: bytes, negative: bool) -> float:
    """The float32 nearest the decimal ``text``, ties to even, as a
    Python float: the double nearest it, or, where that double lies
    halfway between two float32s, exact rational arithmetic."""
    import numpy as np
    from fractions import Fraction
    d = float(text)
    f = np.float32(d)
    if np.isfinite(f) and float(f) != d:
        other = np.nextafter(f, np.float32(np.inf if float(f) < d
                                           else -np.inf))
        if (float(f) + float(other)) / 2 == d:
            # the double is the midpoint: the text's side of it decides
            exact = Fraction(text.decode())
            if exact != d:
                f = max(f, other) if exact > d else min(f, other)
    v = float(f)
    return -v if negative else v


def parse_double_plain(offsets: torch.Tensor, data: torch.Tensor,
                       valid: torch.Tensor, f32: bool = False):
    """Plain version of ``parse_double``: the kernel's grammar as a
    regular expression, and the value from Python's ``float`` (and exact
    rational arithmetic for a float32 halfway case), which round
    correctly.  A host loop over the rows, for the CPU alone: it never
    runs when a card is present."""
    import math
    buf = bytes(data.cpu().numpy().tobytes())
    offs = offsets.cpu().tolist()
    ok = valid.cpu().tolist()
    vals = []
    good = []
    for r in range(valid.shape[0]):
        v, g = 0.0, False
        if ok[r]:
            text = buf[offs[r]:offs[r + 1]]
            lo, hi = 0, len(text)
            while lo < hi and text[lo] <= 32:
                lo += 1
            while hi > lo and text[hi - 1] <= 32:
                hi -= 1
            m = FLOAT_TEXT.fullmatch(text, lo, hi)
            if m is not None:
                g = True
                neg = m.group(1) == b"-"
                if m.group(2):
                    word = m.group(2).lower()
                    v = math.nan if word == b"nan" else \
                        (-math.inf if neg else math.inf)
                elif f32:
                    v = _float32_of(m.group(3), neg)
                else:
                    v = float(m.group(3))
                    v = -v if neg else v
        vals.append(v)
        good.append(g)
    dt = torch.float32 if f32 else torch.float64
    return (torch.tensor(vals, dtype=dt, device=valid.device),
            torch.tensor(good, dtype=torch.bool, device=valid.device))


def parse_double(offsets: torch.Tensor, data: torch.Tensor,
                 valid: torch.Tensor, f32: bool = False):
    """(value float64[n] or float32[n], ok bool[n]): each row's text
    (bytes ``[offsets[i], offsets[i + 1])`` of ``data``) read as a
    number, correctly rounded (ties to even), as Java's
    ``Double.parseDouble`` / ``Float.parseFloat`` and Spark's special
    literals read it (``parse_double_plain`` gives the grammar); ``ok``
    is False for a null row and for text that is no number.  NaN is the
    canonical NaN.  On the card, one launch (csrc/numtext.cu)."""
    what = "parse_double"
    n = valid.shape[0]
    if (offsets.dtype != torch.int32 or offsets.shape != (n + 1,) or
            data.dtype != torch.uint8 or valid.dtype != torch.bool):
        raise ValueError(f"{what}: offsets int32[n + 1], data uint8 and "
                         f"valid bool[n]")
    _check_contiguous([offsets, data, valid], what)
    if _device_kind([offsets, data, valid], what) == "cpu":
        return parse_double_plain(offsets, data, valid, f32)
    dev = valid.device
    out = torch.empty(n, dtype=torch.float32 if f32 else torch.float64,
                      device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    table = pow10_table(dev)
    lib = _load("numtext")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.parse_double(offsets.data_ptr(), data.data_ptr(),
                               valid.data_ptr(), n, int(f32),
                               table.data_ptr(), out.data_ptr(),
                               ok.data_ptr(), TEXT_THREADS, stream)
    _raise_on(lib, what, err)
    LAUNCHES[what] += 1
    return out, ok

