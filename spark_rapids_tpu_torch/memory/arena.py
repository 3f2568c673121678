"""Device manager and admission control.

Counterpart of ``spark_rapids_tpu/memory/arena.py`` (the reference's
``GpuDeviceManager`` and ``GpuSemaphore``), without its cancellation
and flight-recorder hooks.  ``DeviceManager`` sizes the catalog's device
budget from the card: ``max(total x pool.fraction - reserve, 1 GiB)``,
the total read with ``torch.cuda.mem_get_info``; ``reserve(nbytes)``
spills catalog entries until ``nbytes`` more fit.  ``DeviceSemaphore``
bounds the threads that work on the device at once.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from .. import config as C
from .catalog import BufferCatalog

#: device bytes assumed for a session on the CPU (no card to ask)
CPU_DEVICE_BYTES = 16 << 30
#: the smallest device budget (the reference's floor)
MIN_DEVICE_LIMIT = 1 << 30


class DeviceSemaphore:
    """Counting semaphore of device permits, re-entrant per thread."""

    def __init__(self, permits: int):
        self.permits = permits
        self._sem = threading.Semaphore(permits)
        self._held = threading.local()

    def held_count(self) -> int:
        """This thread's re-entrant hold depth."""
        return getattr(self._held, "count", 0)

    def acquire_if_necessary(self) -> None:
        """One permit for this thread, unless it holds one already."""
        if self.held_count() == 0:
            self._sem.acquire()
        self._held.count = self.held_count() + 1

    def release(self) -> None:
        count = self.held_count()
        if count > 0:
            self._held.count = count - 1
            if count == 1:
                self._sem.release()

    def release_all(self) -> int:
        """Drop every level this thread holds; returns the depth."""
        count = self.held_count()
        if count > 0:
            self._held.count = 0
            self._sem.release()
        return count

    @contextlib.contextmanager
    def released(self):
        """The block runs without this thread's permit, and the same
        depth is held again after it."""
        held = self.release_all()
        try:
            yield
        finally:
            for _ in range(held):
                self.acquire_if_necessary()


class DeviceManager:
    _instance: Optional["DeviceManager"] = None

    def __init__(self, conf: Optional[C.TpuConf] = None,
                 device="cpu"):
        conf = conf if conf is not None else C.TpuConf()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.hbm_total = int(torch.cuda.mem_get_info(self.device)[1])
        else:
            self.hbm_total = CPU_DEVICE_BYTES
        self.device_limit = max(
            int(self.hbm_total * conf.get(C.HBM_POOL_FRACTION)) -
            conf.get(C.HBM_RESERVE), MIN_DEVICE_LIMIT)
        self.catalog = BufferCatalog.reset(
            spill_dir=conf.get(C.SPILL_DIR), device_limit=self.device_limit,
            host_limit=conf.get(C.HOST_SPILL_LIMIT))
        self.semaphore = DeviceSemaphore(conf.get(C.CONCURRENT_TPU_TASKS))

    @classmethod
    def get(cls) -> "DeviceManager":
        """The process's manager; a session makes it for its device
        (``initialize``), else it is sized for the CPU."""
        if cls._instance is None:
            cls._instance = DeviceManager()
        return cls._instance

    @classmethod
    def initialize(cls, conf: Optional[C.TpuConf] = None,
                   device="cpu") -> "DeviceManager":
        cls._instance = DeviceManager(conf, device)
        return cls._instance

    def reserve(self, nbytes: int) -> None:
        """Room for ``nbytes`` more under the budget, spilling catalog
        entries if needed."""
        cat = BufferCatalog.get()
        if cat.device_bytes + nbytes > cat.device_limit:
            cat.spill_device_to_fit(nbytes)
