"""Hash partitioner: partition ids on the device, then a contiguous split.

Counterpart of ``spark_rapids_tpu/shuffle/partitioners.py``.  The split
hashes the keys' canonical words (a null key hashes a fixed word) and
orders the rows by partition id in one ``hash_split`` call, a counting
sort on the card; the per-partition counts are read to the host once per
batch to cut the slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch
from ..expr import core as ec
from ..kernels import canon
from ..kernels.basic import as_signed64
from ..kernels.cuda_ops import hash_split

#: word hashed for a null key
NULL_WORD = as_signed64(0x9E3779B97F4A7C15)


@dataclasses.dataclass
class SplitBatch:
    """A batch sorted by partition id + per-partition row offsets."""
    batch: ColumnarBatch
    offsets: np.ndarray          # [num_parts + 1] host row offsets

    def partition_slice(self, pid: int) -> Optional[ColumnarBatch]:
        lo, hi = int(self.offsets[pid]), int(self.offsets[pid + 1])
        if hi <= lo:
            return None
        return self.batch.slice(lo, hi - lo)


class HashPartitioner:
    """murmur-style hash of the key columns mod n."""

    def __init__(self, key_exprs: List[ec.Expression], num_partitions: int):
        self.key_exprs = key_exprs
        self.num_partitions = num_partitions

    def _key_words(self, batch: ColumnarBatch) -> List[torch.Tensor]:
        words = []
        for e in self.key_exprs:
            col = ec.eval_as_column(e.bind(batch.schema), batch)
            for w in canon.value_words(col):
                words.append(torch.where(col.validity, w, NULL_WORD)
                             .contiguous())
        return words

    def split(self, batch: ColumnarBatch) -> SplitBatch:
        """Rows stably ordered by partition id (dead rows last) and the
        host offsets of each partition's rows."""
        n = self.num_partitions
        perm, counts = hash_split(self._key_words(batch),
                                  batch.live_mask().contiguous(), n)
        counts = counts[:n].cpu().numpy()
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(counts)
        sorted_batch = batch.gather(perm, int(offsets[-1]))
        return SplitBatch(sorted_batch, offsets)
