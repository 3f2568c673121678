"""Session configuration: the conf keys this port reads, and the device.

Counterpart of ``spark_rapids_tpu/config.py``, trimmed to the keys the
port honours.  A key the port does not know raises, so a setting is
never silently ignored.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

VARIABLE_FLOAT_AGG = "spark.rapids.tpu.sql.variableFloatAgg.enabled"
BATCH_SIZE_ROWS = "spark.rapids.tpu.sql.batchSizeRows"
AGG_TABLE_SIZE = "spark.rapids.tpu.sql.agg.tableSize"
SHUFFLE_PARTITIONS = "spark.rapids.tpu.sql.shuffle.partitions"
JOIN_GATHER_CHUNK_ROWS = "spark.rapids.tpu.sql.join.gather.chunkRows"

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
        if self.get(JOIN_GATHER_CHUNK_ROWS) < 1:
            raise ValueError(f"{JOIN_GATHER_CHUNK_ROWS} must be at least 1")

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
