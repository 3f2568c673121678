"""Device OOM -> spill -> retry once.

Counterpart of ``spark_rapids_tpu/memory/pressure.py`` (the reference's
``DeviceMemoryEventHandler`` contract).  The operations that allocate
device memory on the host's behalf (a scan's upload, an unspill, a
slice upload) run through ``oom_retry``: when the allocator fails, the
scan cache is emptied, the whole device tier is spilled, the allocator's
cached blocks go back to the card, and the operation runs once more.
Kernels launched inside an operator are covered by the budget instead
(``DeviceManager.reserve``).
"""
from __future__ import annotations

from typing import Callable

import torch

#: the allocator's message when it raises a plain RuntimeError
_OOM_MARKER = "CUDA out of memory"


def is_device_oom(exc: BaseException) -> bool:
    """True for the CUDA allocator's failure to allocate."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and _OOM_MARKER in str(exc)


def _free_device() -> bool:
    """Empty the scan cache and spill every unpinned device entry;
    whether anything was freed."""
    from ..io.scan_cache import clear_on_pressure
    from .catalog import BufferCatalog
    cache_bytes = clear_on_pressure()
    cat = BufferCatalog.get()
    spilled = cat.spill_device_to_fit(cat.device_limit)
    cat.oom_retries += 1
    return spilled > 0 or cache_bytes > 0


def oom_retry(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``; after a device OOM, free what can be
    freed and call it once more.  Re-raises the OOM when nothing could
    be freed, and every other error as it is."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - filtered by is_device_oom
        if not is_device_oom(e) or not _free_device():
            raise
    # out of the except block: the failed call's frames are released
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return fn(*args, **kwargs)
