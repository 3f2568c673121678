"""Session configuration: the conf keys this port reads, and the device.

Counterpart of ``spark_rapids_tpu/config.py``, trimmed to the keys the
port honours.  A key the port does not know raises, so a setting is
never silently ignored.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import torch

VARIABLE_FLOAT_AGG = "spark.rapids.tpu.sql.variableFloatAgg.enabled"
BATCH_SIZE_ROWS = "spark.rapids.tpu.sql.batchSizeRows"
AGG_TABLE_SIZE = "spark.rapids.tpu.sql.agg.tableSize"
SHUFFLE_PARTITIONS = "spark.rapids.tpu.sql.shuffle.partitions"
JOIN_GATHER_CHUNK_ROWS = "spark.rapids.tpu.sql.join.gather.chunkRows"
HBM_POOL_FRACTION = "spark.rapids.tpu.memory.pool.fraction"
HBM_RESERVE = "spark.rapids.tpu.memory.reserve"
HOST_SPILL_LIMIT = "spark.rapids.tpu.memory.host.spillStorageSize"
SPILL_DIR = "spark.rapids.tpu.memory.spill.dir"
CONCURRENT_TPU_TASKS = "spark.rapids.tpu.sql.concurrentTpuTasks"
SORT_OOC_CHUNK_ROWS = "spark.rapids.tpu.sql.sort.outOfCore.chunkRows"
SORT_OOC_SAMPLES = "spark.rapids.tpu.sql.sort.outOfCore.samplesPerRun"
SCAN_CACHE = "spark.rapids.tpu.io.deviceScanCache.enabled"
SCAN_CACHE_BYTES = "spark.rapids.tpu.io.deviceScanCache.bytes"
ADAPTIVE_ENABLED = "spark.rapids.tpu.sql.adaptive.enabled"
DECIMAL_ENABLED = "spark.rapids.tpu.sql.decimalType.enabled"
ADAPTIVE_TARGET_PARTITION_BYTES = \
    "spark.rapids.tpu.sql.adaptive.targetPartitionBytes"
ADAPTIVE_BROADCAST_BYTES = \
    "spark.rapids.tpu.sql.adaptive.autoBroadcastJoinBytes"
ADAPTIVE_SKEW_FACTOR = "spark.rapids.tpu.sql.adaptive.skewedPartitionFactor"
ADAPTIVE_SKEW_MIN_BYTES = \
    "spark.rapids.tpu.sql.adaptive.skewedPartitionThresholdBytes"

#: the hash split's partition limit (kernels/cuda_ops.SPLIT_MAX_PARTS)
MAX_SHUFFLE_PARTITIONS = 4096

_DEFAULTS: Dict[str, Any] = {
    # Float sums/max may accumulate in an order that varies from run to
    # run (exact mode is deterministic).  Default off, as in Spark.
    VARIABLE_FLOAT_AGG: False,
    # Target rows per scan batch.
    BATCH_SIZE_ROWS: 1 << 20,
    # Bucket-table size of the sort-free group-by path.
    AGG_TABLE_SIZE: 4096,
    # Most partitions of a hash exchange.
    SHUFFLE_PARTITIONS: 8,
    # Join output rows gathered per expansion chunk: a stream batch whose
    # match total is larger expands in pieces of at most this many rows.
    JOIN_GATHER_CHUNK_ROWS: 1 << 22,
    # Share of the card's memory the catalog's device tier may hold, less
    # the reserve below (memory/arena.DeviceManager).
    HBM_POOL_FRACTION: 0.9,
    # Device bytes held back from the budget for temporaries.
    HBM_RESERVE: 1 << 30,
    # Pinned host bytes of spilled buffers before the disk tier.
    HOST_SPILL_LIMIT: 8 << 30,
    # Directory of the disk tier's files (one per spilled buffer).
    SPILL_DIR: os.path.join(tempfile.gettempdir(),
                            "spark_rapids_tpu_torch_spill"),
    # Queries admitted to the device at once (the collect's permits).
    CONCURRENT_TPU_TASKS: 2,
    # A sort partition of more buffered rows than this merges out of
    # core, in range chunks of about this many rows.
    SORT_OOC_CHUNK_ROWS: 1 << 22,
    # Key samples kept per sorted run to choose the merge's cuts.
    SORT_OOC_SAMPLES: 256,
    # Keep uploaded file-scan batches on the device across queries.
    SCAN_CACHE: True,
    # Device bytes the scan cache may hold (the reference's default is
    # 6 GiB; 24 GiB holds every table phases 6-13 of chip_smoke read).
    SCAN_CACHE_BYTES: 24 << 30,
    # Adaptive execution: aggregate and window exchanges read through a
    # coalescing read, and a shuffled equi-join picks broadcast, shuffle
    # and skew splits from the exchanges' statistics (exec/adaptive.py).
    ADAPTIVE_ENABLED: True,
    # Advisory bytes of one partition after a shuffle: adjacent smaller
    # reduce partitions are read as one.
    ADAPTIVE_TARGET_PARTITION_BYTES: 64 << 20,
    # A shuffled join whose build side's shuffled bytes come to at most
    # this is broadcast at run time; its probe side is never shuffled.
    ADAPTIVE_BROADCAST_BYTES: 32 << 20,
    # A probe partition of more bytes than this many times the median,
    # and than the threshold below, is split into slices.
    ADAPTIVE_SKEW_FACTOR: 5.0,
    ADAPTIVE_SKEW_MIN_BYTES: 16 << 20,
    # DECIMAL64 columns and expressions on the device (the reference's
    # ``spark.rapids.sql.decimalType.enabled``).  Off, the reference
    # falls back to its CPU engine; the port has none and refuses the
    # plan, naming this key.
    DECIMAL_ENABLED: True,
}


def _coerce(default, value):
    if isinstance(default, bool):
        if isinstance(value, str):
            return value.strip().lower() == "true"
        return bool(value)
    return type(default)(value)


class TpuConf:
    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        settings = dict(settings or {})
        unknown = sorted(set(settings) - set(_DEFAULTS))
        if unknown:
            raise KeyError(f"conf keys not supported by the port: {unknown}; "
                           f"supported: {sorted(_DEFAULTS)}")
        self._settings = {k: _coerce(_DEFAULTS[k], v)
                          for k, v in settings.items()}
        parts = self.get(SHUFFLE_PARTITIONS)
        if not 1 <= parts <= MAX_SHUFFLE_PARTITIONS:
            raise ValueError(f"{SHUFFLE_PARTITIONS} = {parts}: the hash "
                             f"split takes 1..{MAX_SHUFFLE_PARTITIONS}")
        for key in (JOIN_GATHER_CHUNK_ROWS, SORT_OOC_CHUNK_ROWS,
                    SORT_OOC_SAMPLES, CONCURRENT_TPU_TASKS):
            if self.get(key) < 1:
                raise ValueError(f"{key} must be at least 1")
        if not 0.0 < self.get(HBM_POOL_FRACTION) <= 1.0:
            raise ValueError(f"{HBM_POOL_FRACTION} must lie in (0, 1]")

    def get(self, key: str):
        return self._settings.get(key, _DEFAULTS[key])


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` with no card raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
