"""Hand-written CUDA kernels for Hopper, and their plain torch versions.

Counterpart of ``spark_rapids_tpu/kernels/pallas_ops.py``.  Each kernel
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
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .aggregate import CH_LANES, flip32, part_chunk_lanes, unflip32
from .basic import SIGN64, hash_to_partition, hash_words

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = {"hash_partition": "hash_partition.cu",
           "table_reduce": "table_reduce.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {"hash_partition_ids": 0, "table_reduce": 0}
_MAX_WORDS = 16

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: shared bytes one table_stage block may take, read once when its
#: library loads
_STAGE_BUDGET: List[int] = []


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
    """Build output for one source, named by a digest of source + flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
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
             "fmax": 5, "sum32": 6, "sum64": 7, "max32": 8}
#: bytes per bucket of each sub-row of a kind; a 64-bit one comes last.
#: A raw kind has one sub-row per row of its column.
_SUB_BYTES = {"count": (4,), "icount": (8,), "fsum64": (4,) * 19,
              "fmax64": (4, 4, 8), "fsumv": (4, 8), "fmax": (4, 4, 4),
              "sum32": (4,), "sum64": (8,), "max32": (4,)}
_IN_DTYPE = {"count": None, "icount": torch.int64, "fsum64": torch.float64,
             "fmax64": torch.float64, "fsumv": torch.float64,
             "fmax": torch.float64, "sum32": torch.float32,
             "sum64": torch.float64, "max32": torch.float32}
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


def table_stage_plain(bucket: torch.Tensor, table: int,
                      cols: Sequence[StageCol]) -> List[tuple]:
    """Plain torch version of ``table_stage``: index_add_ for the counts
    and sums, the chunk lanes of ``part_chunk_lanes``, and scatter_reduce_
    for the max words."""
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
        else:                                        # fmax64, fmax
            v = torch.where(v == 0.0, 0.0, v)        # -0.0 == 0.0
            okn = ok & ~torch.isnan(v)
            nn = tab(okn, torch.int32)
            hi = v.to(torch.float32)
            if k == "fmax":
                key = torch.where(okn, flip32(hi), 0)
                res.append((cnt, nn,
                            decode_max32(tab(key, torch.int64, "amax"))))
                continue
            lo = torch.where(torch.isfinite(v), v - hi.to(torch.float64),
                             0.0).to(torch.float32)
            # the u64 word flip32(hi) << 32 | flip32(lo) as int64 bits,
            # maxed as a signed max with the top bit flipped
            whi = flip32(hi)
            word = torch.where(whi >= 1 << 31, whi - (1 << 32), whi) * \
                (1 << 32) + flip32(lo)
            w = tab(torch.where(okn, word ^ SIGN64, SIGN64), torch.int64,
                    "amax", SIGN64)
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
    - fsumv:  (count int32, sum float64)
    - fmax:   (count, non-NaN count int32, max float32)
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
    if kind == "fmax64":
        return (r32[0], r32[1], r64[0])
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
