"""The port's memory tiers on the CPU: the buffer catalog's round trips
device -> pinned host -> disk -> device, spill priorities, slices of a
spilled entry, the host tier's cascade to disk, the device semaphore and
the OOM retry.  Mirrors the JAX package's ``tests/test_memory_shuffle.py``,
``tests/test_oom_pressure.py`` and ``tests/test_concurrency.py`` (the
catalog of a CPU session stands in for the card's)."""
import datetime
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.column import StringColumn
from spark_rapids_tpu_torch.memory import catalog as catalog_mod
from spark_rapids_tpu_torch.memory.arena import DeviceManager, DeviceSemaphore
from spark_rapids_tpu_torch.memory.catalog import (
    SHUFFLE_OUTPUT_PRIORITY, BufferCatalog, StorageTier)
from spark_rapids_tpu_torch.memory.pressure import is_device_oom, oom_retry
from spark_rapids_tpu_torch.memory.spillable import SpillableBatch

CPU = torch.device("cpu")


@pytest.fixture
def cat(tmp_path):
    c = BufferCatalog.reset(spill_dir=str(tmp_path / "spill"))
    yield c
    BufferCatalog.reset(spill_dir=str(tmp_path / "spill"))


def _table(n=100, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n)
    d[::7] = np.nan
    d[3::11] = -0.0
    words = ["äöü", "日本語", "", "plain", "naïve façade", None]
    return pa.table({
        "i": pa.array(rng.integers(-10**12, 10**12, n), pa.int64()),
        "d": pa.array(d, pa.float64()),
        "b": pa.array([None if i % 5 == 0 else bool(i % 3) for i in range(n)],
                      pa.bool_()),
        "dt": pa.array([None if i % 9 == 0 else
                        datetime.date(2000, 1, 1) + datetime.timedelta(i)
                        for i in range(n)], pa.date32()),
        "s": pa.array([words[i % len(words)] for i in range(n)],
                      pa.string()),
    })


def _same(a: pa.Table, b: pa.Table) -> bool:
    """Equal schemas, nulls and values, floats bit for bit (NaN and -0.0
    included, which ``Table.equals`` does not take as equal)."""
    if not a.schema.equals(b.schema) or a.num_rows != b.num_rows:
        return False
    for x, y in zip(a.columns, b.columns):
        x, y = x.combine_chunks(), y.combine_chunks()
        if not np.array_equal(np.asarray(x.is_null()),
                              np.asarray(y.is_null())):
            return False
        xv = x.to_numpy(zero_copy_only=False)
        yv = y.to_numpy(zero_copy_only=False)
        if xv.dtype.kind == "f":
            xv, yv = xv.view(np.int64), yv.view(np.int64)
        valid = ~np.asarray(x.is_null())
        if not np.array_equal(xv[valid], yv[valid]):
            return False
    return True


def _bits(batch):
    """Every buffer of the batch as raw bytes (a string's offsets too)."""
    out = []
    for c in batch.columns:
        bufs = [c.data, c.validity]
        if isinstance(c, StringColumn):
            bufs.append(c.offsets)
        out += [b.contiguous().view(torch.uint8).numpy().tobytes()
                for b in bufs]
    return out


@pytest.mark.parametrize("tiers", ["host", "disk"])
def test_round_trip_is_bit_for_bit(cat, tiers):
    if tiers == "disk":
        cat.host_limit = 0
    batch = from_arrow(_table(), CPU)
    want = _bits(batch)
    sb = SpillableBatch(batch, catalog=cat)
    cat.spill_device_to_fit(cat.device_limit)
    e = cat._entries[sb.buffer_id]
    assert e.tier == (StorageTier.DISK if tiers == "disk"
                      else StorageTier.HOST)
    assert cat.device_bytes == 0 and cat.spilled_device_to_host == sb.nbytes
    if tiers == "disk":
        assert cat.spilled_host_to_disk == sb.nbytes
        assert len(os.listdir(cat.spill_dir)) == 1
    got = sb.materialize()
    assert e.tier == StorageTier.DEVICE and cat.unspills == 1
    assert _bits(got) == want
    assert _same(to_arrow(got), _table())
    sb.close()
    assert cat.stats()["num_buffers"] == 0
    assert cat.device_bytes == cat.host_bytes == cat.disk_bytes == 0
    if tiers == "disk":
        assert os.listdir(cat.spill_dir) == []


def test_spill_priority_order(cat):
    low = SpillableBatch(from_arrow(_table(seed=1), CPU),
                         SHUFFLE_OUTPUT_PRIORITY, catalog=cat)
    mid = SpillableBatch(from_arrow(_table(seed=2), CPU), catalog=cat)
    high = SpillableBatch(from_arrow(_table(seed=3), CPU), 100, catalog=cat)
    # room for one more batch: the lowest priority goes first
    cat.device_limit = cat.device_bytes
    cat.spill_device_to_fit(low.nbytes)
    tiers = [cat._entries[b.buffer_id].tier for b in (low, mid, high)]
    assert tiers == [StorageTier.HOST, StorageTier.DEVICE,
                     StorageTier.DEVICE]
    cat.spill_device_to_fit(low.nbytes + mid.nbytes)
    tiers = [cat._entries[b.buffer_id].tier for b in (low, mid, high)]
    assert tiers == [StorageTier.HOST, StorageTier.HOST, StorageTier.DEVICE]
    for b in (low, mid, high):
        b.close()


def test_pinned_entry_stays_and_shortfall_is_reported(cat):
    sb = SpillableBatch(from_arrow(_table(), CPU), catalog=cat)
    sb.materialize()                       # pinned while in use
    assert cat.spill_device_to_fit(cat.device_limit) == 0
    assert cat._entries[sb.buffer_id].tier == StorageTier.DEVICE
    assert cat.stats()["pinned_shortfalls"] == 1
    assert cat.stats()["pinned_shortfall_bytes"] == sb.nbytes
    sb.release()
    assert cat.spill_device_to_fit(cat.device_limit) == sb.nbytes
    sb.close()


@pytest.mark.parametrize("tier", [StorageTier.DEVICE, StorageTier.HOST,
                                  StorageTier.DISK])
def test_acquire_slice_keeps_the_tier(cat, tier):
    table = _table(300, seed=4)
    sb = SpillableBatch(from_arrow(table, CPU), catalog=cat)
    if tier != StorageTier.DEVICE:
        cat.host_limit = 0 if tier == StorageTier.DISK else 1 << 40
        cat.spill_device_to_fit(cat.device_limit)
    assert sb.catalog.tier(sb.buffer_id) == tier
    for lo, hi in ((10, 35), (0, 300), (299, 300), (120, 120)):
        got = sb.materialize_slice(lo, hi)
        assert sb.catalog.tier(sb.buffer_id) == tier
        assert got.num_rows == hi - lo
        assert _same(to_arrow(got), table.slice(lo, hi - lo))
    assert cat.unspills == 0
    sb.close()


def test_demote_cascades_to_disk_past_the_host_limit(cat):
    a = SpillableBatch(from_arrow(_table(seed=5), CPU), catalog=cat)
    b = SpillableBatch(from_arrow(_table(seed=6), CPU), catalog=cat)
    cat.host_limit = a.nbytes + b.nbytes // 2
    a.demote()
    assert cat.tier(a.buffer_id) == StorageTier.HOST
    b.demote()                             # the host tier is over: a first
    assert cat.tier(a.buffer_id) == StorageTier.DISK
    assert cat.tier(b.buffer_id) == StorageTier.HOST
    assert cat.host_bytes <= cat.host_limit
    assert _same(to_arrow(a.materialize()), _table(seed=5))
    a.close()
    b.close()


def test_disk_tier_that_cannot_write_raises(cat, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    cat.spill_dir = str(blocker)
    cat.host_limit = 0
    sb = SpillableBatch(from_arrow(_table(), CPU), catalog=cat)
    with pytest.raises(OSError):
        cat.spill_device_to_fit(cat.device_limit)
    # the entry stays on the host, whole
    assert cat.tier(sb.buffer_id) == StorageTier.HOST
    assert _same(to_arrow(sb.materialize()), _table())
    sb.close()


def test_device_manager_budget():
    from spark_rapids_tpu_torch.config import TpuConf
    m = DeviceManager(TpuConf(), "cpu")
    assert m.device_limit == int(m.hbm_total * 0.9) - (1 << 30)
    small = DeviceManager(TpuConf({
        "spark.rapids.tpu.memory.pool.fraction": 0.01,
        "spark.rapids.tpu.memory.host.spillStorageSize": 12345}), "cpu")
    assert small.device_limit == 1 << 30          # the floor
    assert small.catalog.host_limit == 12345
    assert BufferCatalog.get() is small.catalog


class TestDeviceSemaphore:
    def test_bounds_concurrent_holders(self):
        sem = DeviceSemaphore(2)
        active, peak = [], []
        lock = threading.Lock()

        def task():
            sem.acquire_if_necessary()
            try:
                with lock:
                    active.append(1)
                    peak.append(len(active))
                time.sleep(0.02)
                with lock:
                    active.pop()
            finally:
                sem.release()
        ts = [threading.Thread(target=task) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert max(peak) <= 2
        assert len(peak) == 8

    def test_reentrant_same_thread(self):
        sem = DeviceSemaphore(1)
        sem.acquire_if_necessary()
        sem.acquire_if_necessary()          # no deadlock
        assert sem.held_count() == 2
        sem.release()
        sem.release()
        assert sem.held_count() == 0
        assert sem._sem.acquire(blocking=False)   # the permit came back
        sem._sem.release()

    def test_released_restores_depth(self):
        sem = DeviceSemaphore(1)
        sem.acquire_if_necessary()
        sem.acquire_if_necessary()
        with sem.released():
            assert sem.held_count() == 0
            other = []
            t = threading.Thread(target=lambda: (
                sem.acquire_if_necessary(), other.append(1), sem.release()))
            t.start()
            t.join(5)
            assert other == [1]             # the permit was free
        assert sem.held_count() == 2
        sem.release_all()


def test_is_device_oom_classifier():
    assert is_device_oom(torch.cuda.OutOfMemoryError("out of memory"))
    assert is_device_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not is_device_oom(RuntimeError("shape mismatch"))
    assert not is_device_oom(ValueError("CUDA out of memory"))


def test_oom_retry_spills_and_retries(cat):
    sb = SpillableBatch(from_arrow(_table(), CPU), catalog=cat)
    calls = []

    def put():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"
    assert oom_retry(put) == "ok"
    assert len(calls) == 2
    assert cat.tier(sb.buffer_id) == StorageTier.HOST
    assert cat.oom_retries == 1
    sb.close()


def test_oom_retry_reraises_when_nothing_spillable(cat):
    def put():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        oom_retry(put)
    assert cat.oom_retries == 1


def test_oom_retry_passes_other_errors(cat):
    sb = SpillableBatch(from_arrow(_table(), CPU), catalog=cat)

    def bad():
        raise ValueError("not an oom")
    with pytest.raises(ValueError):
        oom_retry(bad)
    assert cat.tier(sb.buffer_id) == StorageTier.DEVICE
    assert cat.oom_retries == 0
    sb.close()


def test_unspill_retries_after_an_oom(cat, monkeypatch):
    """An unspill whose upload meets an OOM spills the device tier (the
    unpinned victim) and uploads again."""
    victim = SpillableBatch(from_arrow(_table(500, seed=7), CPU),
                            catalog=cat)
    sb = SpillableBatch(from_arrow(_table(50, seed=8), CPU), catalog=cat)
    cat.spill_device_to_fit(cat.device_limit)
    victim.materialize()
    victim.release()
    assert cat.tier(victim.buffer_id) == StorageTier.DEVICE
    real = catalog_mod._deserialize
    calls = []

    def flaky(h):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(h)
    monkeypatch.setattr(catalog_mod, "_deserialize", flaky)
    got = sb.materialize()
    assert _same(to_arrow(got), _table(50, seed=8))
    assert len(calls) == 2
    assert cat.tier(victim.buffer_id) == StorageTier.HOST
    sb.close()
    victim.close()


def test_scan_upload_retries_after_an_oom(cat, monkeypatch):
    """``from_arrow`` (every scan's upload) runs through ``oom_retry``."""
    from spark_rapids_tpu_torch.columnar import arrow as arrow_mod
    victim = SpillableBatch(from_arrow(_table(seed=9), CPU), catalog=cat)
    real = arrow_mod._column_from_arrow
    calls = []

    def flaky(*a):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a)
    monkeypatch.setattr(arrow_mod, "_column_from_arrow", flaky)
    got = from_arrow(_table(seed=10), CPU)
    assert _same(to_arrow(got), _table(seed=10))
    assert cat.tier(victim.buffer_id) == StorageTier.HOST
    victim.close()
