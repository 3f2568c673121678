"""Hashing, id and random expressions: ``hash``, ``md5``, ``rand``,
``monotonically_increasing_id`` and ``spark_partition_id``.

Counterpart of ``spark_rapids_tpu/expr/misc.py``.  ``Murmur3Hash`` is
the reference's: ``kernels/basic.hash_words`` with seed 42 over each
argument's words, a null row's words replaced by a tag so that
``hash(NULL)`` differs from ``hash(0)``.  A number, BOOL or DATE hashes
its ``canon.value_words``, bit for bit the reference's; a string hashes
``strings.partition_words``, a fold of its own bytes (the reference's
string words depend on the widest string of the batch, so one string
hashed differently in two batches).

``Md5`` is MD5 of each row's UTF-8 bytes as 32 lowercase hex digits,
computed in torch over every row at once: each row padded into its
64-byte blocks, the 64 rounds run on every row's block j together, a
row with fewer blocks left as it is (the reference loops over rows with
``hashlib``).

``Rand(seed)`` is uniform in [0, 1): a counter-based draw, ``mix64`` of
the seed, the partition's index and the row's index in the partition,
so that a value does not depend on how the partition is cut into
batches (the reference's ``jax.random`` key takes the batch's first row,
and Spark's XORShiftRandom runs a sequence per partition; neither
stream is reproduced, so tests compare distributions).

The id expressions and ``Rand`` read the task that evaluates them
(``TaskContext``: the partition's index and the rows of the partition
before this batch), which ``exec/tpu_basic``'s project and filter set on
each batch; the planner stages no such expression into an aggregate.
The ids are Spark's: ``partition << 33 | row in the partition`` and the
partition's index (the reference has no task context and answers
partition 0, row 0 at every batch's start).
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from ..columnar import dtypes as T
from ..columnar.column import Column, StringColumn
from ..kernels import basic, canon, strings
from ..kernels.numtext import from_matrix
from .core import Expression, eval_as_column

#: the words of a null row (the reference's tag)
NULL_TAG = basic.as_signed64(0x9E3779B97F4A7C15)


class Murmur3Hash(Expression):
    """``hash(cols...)``: a bigint, never null."""

    def __init__(self, *children: Expression, seed: int = 42):
        self.children = list(children)
        self.seed = seed

    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        word_lists = []
        for ch in self.children:
            col = eval_as_column(ch, batch)
            words = strings.partition_words(col) \
                if isinstance(col, StringColumn) else canon.value_words(col)
            word_lists += [torch.where(col.validity, w, NULL_TAG)
                           for w in words]
        h = basic.hash_words(word_lists, seed=self.seed)
        return Column(T.INT64, h, torch.ones_like(h, dtype=torch.bool))

    def __repr__(self):
        return f"hash({', '.join(map(repr, self.children))})"


@dataclasses.dataclass
class TaskContext:
    """The task a batch is evaluated in: its partition's index and the
    rows of that partition before the batch (a device scalar or an
    int)."""
    partition_id: int
    row_start: Union[int, torch.Tensor] = 0


def needs_task(e: Expression) -> bool:
    """Whether evaluating ``e`` reads the batch's ``TaskContext``."""
    return bool(e.collect(lambda x: isinstance(x, _TaskExpression)))


class _TaskExpression(Expression):
    children = []

    @property
    def nullable(self):
        return False

    @staticmethod
    def _task(batch) -> TaskContext:
        ctx = getattr(batch, "task_context", None)
        if ctx is None:
            raise NotImplementedError(
                f"this operator does not evaluate partition-aware "
                f"expressions (monotonically_increasing_id, "
                f"spark_partition_id)")
        return ctx


class MonotonicallyIncreasingID(_TaskExpression):
    """``partition << 33 | row in the partition`` (Spark's contract)."""

    def dtype(self):
        return T.INT64

    def columnar_eval(self, batch):
        ctx = self._task(batch)
        rows = torch.arange(batch.capacity, dtype=torch.int64,
                            device=batch.device) + ctx.row_start
        ids = (ctx.partition_id << 33) | rows
        return Column(T.INT64, ids, torch.ones_like(ids, dtype=torch.bool))

    def __repr__(self):
        return "monotonically_increasing_id()"


class SparkPartitionID(_TaskExpression):
    def dtype(self):
        return T.INT32

    def columnar_eval(self, batch):
        pid = self._task(batch).partition_id
        data = torch.full((batch.capacity,), pid, dtype=torch.int32,
                          device=batch.device)
        return Column(T.INT32, data, torch.ones_like(data, dtype=torch.bool))

    def __repr__(self):
        return "spark_partition_id()"


_MASK32 = 0xFFFFFFFF
#: MD5's per-round additive constants, shifts and message word order
_MD5_K = [int(abs(__import__("math").sin(i + 1)) * 2 ** 32) & _MASK32
          for i in range(64)]
_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + \
    [6, 10, 15, 21] * 4
_MD5_G = [i for i in range(16)] + [(5 * i + 1) % 16 for i in range(16)] + \
    [(3 * i + 5) % 16 for i in range(16)] + [(7 * i) % 16 for i in range(16)]
_HEX = b"0123456789abcdef"


def md5_rows(col) -> torch.Tensor:
    """int64[cap, 32]: the ASCII hex digits of each row's MD5."""
    dev = col.offsets.device
    starts = col.offsets[:-1].to(torch.int64)
    lens = (col.offsets[1:] - col.offsets[:-1]).to(torch.int64)
    blocks = (lens + 8) // 64 + 1
    most = (col.max_bytes + 8) // 64 + 1
    width = most * 64
    k = torch.arange(width, device=dev)
    idx = (starts[:, None] + k).clamp(0, max(col.data.shape[0] - 1, 0))
    msg = torch.where(k < lens[:, None], col.data[idx].to(torch.int64), 0)
    msg = torch.where(k == lens[:, None], 0x80, msg)
    # the bit length, little-endian, in the last 8 bytes of the last block
    at = k - (blocks * 64 - 8)[:, None]
    bits = lens * 8
    msg = torch.where((at >= 0) & (at < 8),
                      (bits[:, None] >> (8 * at.clamp(0, 7))) & 0xFF, msg)
    b = msg.reshape(-1, most * 16, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | \
        (b[..., 3] << 24)
    state = [torch.full_like(lens, v) for v in
             (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476)]
    for j in range(most):
        x = words[:, 16 * j:16 * (j + 1)]
        a, bb, c, d = state
        for i in range(64):
            if i < 16:
                f = (bb & c) | (~bb & d)
            elif i < 32:
                f = (d & bb) | (~d & c)
            elif i < 48:
                f = bb ^ c ^ d
            else:
                f = c ^ (bb | (~d & _MASK32))
            f = (f + a + _MD5_K[i] + x[:, _MD5_G[i]]) & _MASK32
            s = _MD5_S[i]
            rot = ((f << s) | (f >> (32 - s))) & _MASK32
            a, d, c, bb = d, c, bb, (bb + rot) & _MASK32
        live = blocks > j
        state = [torch.where(live, (o + v) & _MASK32, o)
                 for o, v in zip(state, (a, bb, c, d))]
    digest = torch.stack([(w >> (8 * i)) & 0xFF for w in state
                          for i in range(4)], 1)
    hexes = torch.tensor(list(_HEX), dtype=torch.int64, device=dev)
    return torch.stack([hexes[digest >> 4], hexes[digest & 15]],
                       2).reshape(-1, 32)


class Md5(Expression):
    """``md5(str)``: 32 lowercase hex digits of the MD5 of the row's
    UTF-8 bytes; null where the row is."""

    def __init__(self, child: Expression):
        self.children = [child]

    def dtype(self):
        return T.STRING

    def columnar_eval(self, batch):
        col = eval_as_column(self.children[0], batch)
        if not isinstance(col, StringColumn):
            from .cast import cast_column
            col = cast_column(col, T.STRING)
        out = md5_rows(col)
        return from_matrix(out, torch.full_like(col.validity, 32,
                                                 dtype=torch.int64),
                            col.validity, 32)

    def __repr__(self):
        return f"md5({self.children[0]!r})"


class Rand(_TaskExpression):
    """``rand(seed)``: a double uniform in [0, 1), a function of the seed,
    the partition's index and the row's index in the partition."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def dtype(self):
        return T.FLOAT64

    def columnar_eval(self, batch):
        ctx = self._task(batch)
        key = basic.mix64(torch.tensor(
            [basic.as_signed64(self.seed * 0x9E3779B97F4A7C15 +
                               ctx.partition_id)], dtype=torch.int64,
            device=batch.device))
        rows = torch.arange(batch.capacity, dtype=torch.int64,
                            device=batch.device) + ctx.row_start
        x = basic.mix64(key ^ basic.mix64(rows + 1))
        vals = basic.srl64(x, 11).to(torch.float64) * 2.0 ** -53
        return Column(T.FLOAT64, vals,
                      torch.ones_like(vals, dtype=torch.bool))

    def __repr__(self):
        return f"rand({self.seed})"
