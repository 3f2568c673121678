"""Tiered buffer catalog: device -> pinned host -> disk.

Counterpart of ``spark_rapids_tpu/memory/catalog.py`` (the reference's
``RapidsBufferCatalog`` and its stores), without its codecs and its
observability hooks.  A registered batch starts in the DEVICE tier and
is counted against ``device_limit``; ``spill_device_to_fit`` moves the
lowest-priority unpinned entries to the HOST tier, then the HOST tier's
lowest-priority entries to DISK while it holds more than ``host_limit``.
``acquire`` brings an entry back to the device (an unspill);
``acquire_slice`` uploads rows ``[lo, hi)`` alone and leaves a spilled
entry where it is (the out-of-core sort's reads).

The host tier keeps each column's buffers as CPU tensors, pinned when
the batch came from a card: a fixed-width column's data and validity, a
STRING's offsets (rebased to 0), its bytes and its validity.  A device
to host copy completes (the stream is synchronised) before the entry
lets go of its device tensors; an unspill's host to device copies are
queued on the current stream, ahead of every kernel that reads them.
The disk tier writes one file per entry under ``spill_dir``: the same
buffers one after another, raw, so that a slice reads only its own
bytes.  A spill, unspill or disk write that fails raises; nothing stays
on the device past the budget without ``stats()`` saying so
(``pinned_shortfalls``: a spill that found only pinned entries left).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import threading
import uuid
from typing import Dict, List, Optional, Tuple

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, StringColumn, bucket_capacity


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


# Spill priorities (the reference's SpillPriorities): lower spills first;
# shuffle output goes before the batches an operator is working on.
SHUFFLE_OUTPUT_PRIORITY = -100
ACTIVE_BATCH_PRIORITY = 0
ACTIVE_ON_DECK_PRIORITY = 100


@dataclasses.dataclass
class HostBatch:
    """A batch off the device: per column its kind (``"fixed"`` or
    ``"string"``) and host buffers, the string bound ``max_bytes``, and
    where the batch came from."""
    schema: object
    num_rows: int
    device: torch.device
    kinds: List[str]
    max_bytes: List[int]
    buffers: List[Optional[torch.Tensor]]
    #: (dtype, elements, byte offset in the file) of each buffer
    layout: List[Tuple[torch.dtype, int, int]]


@dataclasses.dataclass
class BufferEntry:
    buffer_id: str
    tier: StorageTier
    nbytes: int
    priority: int
    device_obj: Optional[ColumnarBatch] = None
    host: Optional[HostBatch] = None
    disk_path: Optional[str] = None
    #: materialised handles in use: a pinned entry is never spilled
    refcount: int = 0


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, pinned when it lies on a card (queued; the
    caller synchronises before reading it or freeing ``t``)."""
    t = t.contiguous()
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def _padded(t: torch.Tensor, cap: int) -> torch.Tensor:
    if t.shape[0] >= cap:
        return t
    return torch.cat([t, t.new_zeros(cap - t.shape[0])])


def _serialize(batch: ColumnarBatch) -> HostBatch:
    """The batch's buffers copied to the host, whole capacity kept (a
    round trip is bit for bit); a STRING keeps the bytes its rows use."""
    rows = batch.num_rows
    strs = [c for c in batch.columns if isinstance(c, StringColumn)]
    ends = []
    if strs:
        # one host read: each string column's first and last offsets
        ends = torch.stack([torch.stack([c.offsets[0], c.offsets[-1]])
                            for c in strs]).tolist()
    kinds, bounds, bufs = [], [], []
    si = 0
    for c in batch.columns:
        if isinstance(c, StringColumn):
            base, end = ends[si]
            si += 1
            kinds.append("string")
            bounds.append(c.max_bytes)
            bufs += [_to_host(c.offsets - base), _to_host(c.data[base:end]),
                     _to_host(c.validity)]
        else:
            kinds.append("fixed")
            bounds.append(0)
            bufs += [_to_host(c.data), _to_host(c.validity)]
    if batch.device.type == "cuda":
        torch.cuda.current_stream(batch.device).synchronize()
    layout, pos = [], 0
    for b in bufs:
        layout.append((b.dtype, b.numel(), pos))
        pos += b.numel() * b.element_size()
    return HostBatch(batch.schema, rows, batch.device, kinds, bounds, bufs,
                     layout)


def _columns(h: HostBatch, fetch, lo: int, hi: int, cap: int) -> list:
    """Device columns of rows ``[lo, hi)`` padded to ``cap``; ``fetch(i,
    a, b)`` gives elements ``[a, b)`` of buffer ``i`` on the host."""
    n = hi - lo
    cols, i = [], 0
    for f, kind, mb in zip(h.schema, h.kinds, h.max_bytes):
        if kind == "string":
            offs = fetch(i, lo, hi + 1)
            base, end = int(offs[0]), int(offs[-1])
            rebased = _padded((offs - base), cap + 1)
            rebased[n + 1:] = end - base
            data = fetch(i + 1, base, end)
            valid = _padded(fetch(i + 2, lo, hi), cap)
            cols.append(StringColumn(_to_device(rebased, h.device),
                                     _to_device(data, h.device),
                                     _to_device(valid, h.device), mb))
            i += 3
        else:
            data = _padded(fetch(i, lo, hi), cap)
            valid = _padded(fetch(i + 1, lo, hi), cap)
            cols.append(Column(f.dtype, _to_device(data, h.device),
                               _to_device(valid, h.device)))
            i += 2
    return cols


def _deserialize(h: HostBatch) -> ColumnarBatch:
    """The whole batch back on its device, capacity as it was."""
    cols, i = [], 0
    for f, kind, mb in zip(h.schema, h.kinds, h.max_bytes):
        if kind == "string":
            offs, data, valid = h.buffers[i:i + 3]
            cols.append(StringColumn(_to_device(offs, h.device),
                                     _to_device(data, h.device),
                                     _to_device(valid, h.device), mb))
            i += 3
        else:
            data, valid = h.buffers[i:i + 2]
            cols.append(Column(f.dtype, _to_device(data, h.device),
                               _to_device(valid, h.device)))
            i += 2
    return ColumnarBatch(h.schema, cols, h.num_rows, device=h.device)


def _slice(h: HostBatch, fetch, lo: int, hi: int) -> ColumnarBatch:
    lo = max(0, min(lo, h.num_rows))
    hi = max(lo, min(hi, h.num_rows))
    n = hi - lo
    return ColumnarBatch(h.schema, _columns(h, fetch, lo, hi,
                                            bucket_capacity(n)), n,
                         device=h.device)


def _host_fetch(h: HostBatch):
    return lambda i, a, b: h.buffers[i][a:b]


def _disk_fetch(h: HostBatch, path: str):
    """Reads elements ``[a, b)`` of one buffer from the entry's file."""
    def fetch(i, a, b):
        dtype, count, off = h.layout[i]
        a, b = max(0, min(a, count)), max(0, min(b, count))
        out = torch.empty(max(b - a, 0), dtype=dtype)
        size = out.element_size()
        with open(path, "rb") as f:
            f.seek(off + a * size)
            _read_into(f, out)
        return out
    return fetch


def _read_into(f, t: torch.Tensor) -> None:
    nbytes = t.numel() * t.element_size()
    if nbytes == 0:
        return
    view = memoryview(t.view(torch.uint8).numpy()).cast("B")
    got = f.readinto(view)
    if got != nbytes:
        raise IOError(f"spill file {f.name}: read {got} of {nbytes} bytes")


class BufferCatalog:
    """Process-wide registry of spillable buffers."""

    _instance: Optional["BufferCatalog"] = None

    def __init__(self, spill_dir: str, device_limit: int = 1 << 30,
                 host_limit: int = 8 << 30):
        self._entries: Dict[str, BufferEntry] = {}
        self._lock = threading.RLock()
        self.spill_dir = spill_dir
        self.device_limit = device_limit
        self.host_limit = host_limit
        self.device_bytes = 0
        self.device_peak_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.spilled_device_to_host = 0
        self.spilled_host_to_disk = 0
        self.unspills = 0
        self.unspilled_bytes = 0
        self.oom_retries = 0
        #: spills that could not meet their target: only pinned entries
        #: were left on the device (and the bytes over it the last time)
        self.pinned_shortfalls = 0
        self.pinned_shortfall_bytes = 0

    @classmethod
    def get(cls) -> "BufferCatalog":
        """The process's catalog (``DeviceManager`` makes it)."""
        if cls._instance is None:
            from .arena import DeviceManager
            DeviceManager.get()
        return cls._instance

    @classmethod
    def reset(cls, **kwargs) -> "BufferCatalog":
        """A new process-wide catalog; the old one's entries are dropped
        and their spill files removed."""
        old = cls._instance
        if old is not None:
            for bid in list(old._entries):
                old.unregister(bid)
        cls._instance = BufferCatalog(**kwargs)
        return cls._instance

    # -- registration ---------------------------------------------------
    def register(self, batch: ColumnarBatch, nbytes: int,
                 priority: int = ACTIVE_BATCH_PRIORITY) -> str:
        buffer_id = uuid.uuid4().hex
        with self._lock:
            self._entries[buffer_id] = BufferEntry(
                buffer_id, StorageTier.DEVICE, nbytes, priority,
                device_obj=batch)
            self.device_bytes += nbytes
            self.device_peak_bytes = max(self.device_peak_bytes,
                                         self.device_bytes)
        return buffer_id

    def unregister(self, buffer_id: str) -> None:
        with self._lock:
            e = self._entries.pop(buffer_id, None)
            if e is None:
                return
            if e.tier == StorageTier.DEVICE:
                self.device_bytes -= e.nbytes
            elif e.tier == StorageTier.HOST:
                self.host_bytes -= e.nbytes
            else:
                self.disk_bytes -= e.nbytes
                os.unlink(e.disk_path)

    def tier(self, buffer_id: str) -> StorageTier:
        with self._lock:
            return self._entries[buffer_id].tier

    def unpin(self, buffer_id: str) -> None:
        with self._lock:
            e = self._entries.get(buffer_id)
            if e is not None and e.refcount > 0:
                e.refcount -= 1

    # -- reads ----------------------------------------------------------
    def acquire(self, buffer_id: str, pin: bool = False) -> ColumnarBatch:
        """The entry's batch on the device (an unspill if it was not);
        ``pin`` keeps it there until ``unpin``."""
        with self._lock:
            e = self._entries[buffer_id]
            if e.tier == StorageTier.DISK:
                self._disk_to_host(e)
            if e.tier == StorageTier.HOST:
                self._host_to_device(e)
            if pin:
                e.refcount += 1
            return e.device_obj

    def acquire_slice(self, buffer_id: str, lo: int, hi: int
                      ) -> ColumnarBatch:
        """Rows ``[lo, hi)`` on the device; a spilled entry stays where
        it is and only the slice's bytes are read and uploaded."""
        from .pressure import oom_retry
        with self._lock:
            e = self._entries[buffer_id]
            if e.tier == StorageTier.DEVICE:
                return e.device_obj.slice(lo, hi - lo)
            fetch = _host_fetch(e.host) if e.tier == StorageTier.HOST \
                else _disk_fetch(e.host, e.disk_path)
            return oom_retry(_slice, e.host, fetch, lo, hi)

    # -- tier moves -----------------------------------------------------
    def demote(self, buffer_id: str) -> None:
        """A device entry to the host tier, then host entries to disk
        while the host tier is over its limit."""
        with self._lock:
            e = self._entries.get(buffer_id)
            if e is not None and e.tier == StorageTier.DEVICE:
                self._device_to_host(e)
            self._host_to_fit()

    def spill_device_to_fit(self, needed_bytes: int) -> int:
        """Spill unpinned device entries, lowest priority first (oldest
        first within one), until ``needed_bytes`` fit under
        ``device_limit``; then cascade host -> disk past ``host_limit``.
        Returns the bytes spilled off the device."""
        spilled = 0
        with self._lock:
            target = self.device_limit - needed_bytes
            candidates = sorted(
                (e for e in self._entries.values()
                 if e.tier == StorageTier.DEVICE and e.refcount == 0),
                key=lambda e: e.priority)
            for e in candidates:
                if self.device_bytes <= target:
                    break
                self._device_to_host(e)
                spilled += e.nbytes
            if self.device_bytes > max(target, 0):
                self.pinned_shortfalls += 1
                self.pinned_shortfall_bytes = self.device_bytes - \
                    max(target, 0)
            self._host_to_fit()
        return spilled

    def _host_to_fit(self) -> None:
        if self.host_bytes <= self.host_limit:
            return
        for e in sorted((x for x in self._entries.values()
                         if x.tier == StorageTier.HOST),
                        key=lambda x: x.priority):
            if self.host_bytes <= self.host_limit:
                break
            self._host_to_disk(e)

    def _device_to_host(self, e: BufferEntry) -> None:
        e.host = _serialize(e.device_obj)
        e.device_obj = None
        e.tier = StorageTier.HOST
        self.device_bytes -= e.nbytes
        self.host_bytes += e.nbytes
        self.spilled_device_to_host += e.nbytes

    def _host_to_disk(self, e: BufferEntry) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, f"{e.buffer_id}.spill")
        try:
            with open(path, "wb") as f:
                for b in e.host.buffers:
                    if b.numel():
                        f.write(memoryview(b.view(torch.uint8).numpy()))
        except BaseException:
            if os.path.exists(path):
                os.unlink(path)
            raise
        e.host.buffers = [None] * len(e.host.buffers)
        e.disk_path = path
        e.tier = StorageTier.DISK
        self.host_bytes -= e.nbytes
        self.disk_bytes += e.nbytes
        self.spilled_host_to_disk += e.nbytes

    def _disk_to_host(self, e: BufferEntry) -> None:
        pinned = e.host.device.type == "cuda"
        bufs = []
        with open(e.disk_path, "rb") as f:
            for dtype, count, _ in e.host.layout:
                t = torch.empty(count, dtype=dtype, pin_memory=pinned)
                _read_into(f, t)
                bufs.append(t)
        os.unlink(e.disk_path)
        e.host.buffers = bufs
        e.disk_path = None
        e.tier = StorageTier.HOST
        self.disk_bytes -= e.nbytes
        self.host_bytes += e.nbytes

    def _host_to_device(self, e: BufferEntry) -> None:
        from .pressure import oom_retry
        e.device_obj = oom_retry(_deserialize, e.host)
        e.host = None
        e.tier = StorageTier.DEVICE
        self.host_bytes -= e.nbytes
        self.device_bytes += e.nbytes
        self.device_peak_bytes = max(self.device_peak_bytes,
                                     self.device_bytes)
        self.unspills += 1
        self.unspilled_bytes += e.nbytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(device_bytes=self.device_bytes,
                        device_peak_bytes=self.device_peak_bytes,
                        host_bytes=self.host_bytes,
                        disk_bytes=self.disk_bytes,
                        num_buffers=len(self._entries),
                        spilled_device_to_host=self.spilled_device_to_host,
                        spilled_host_to_disk=self.spilled_host_to_disk,
                        unspills=self.unspills,
                        unspilled_bytes=self.unspilled_bytes,
                        oom_retries=self.oom_retries,
                        pinned_shortfalls=self.pinned_shortfalls,
                        pinned_shortfall_bytes=self.pinned_shortfall_bytes)
