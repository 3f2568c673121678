"""Window function expressions: the rank family, ``ntile``, ``lead`` and
``lag``.

Counterpart of ``spark_rapids_tpu/expr/window_funcs.py``.  They are
evaluated only by the window operator (``exec/tpu_window.py``); the
aggregates (``sum``, ``count``, ``avg``, ``min``, ``max``) serve as window
functions too.
"""
from __future__ import annotations

from ..columnar import dtypes as T
from .core import Expression


class WindowFunction(Expression):
    def columnar_eval(self, batch):
        raise AssertionError(f"{self.name} must be evaluated by a window "
                             f"exec")


class _RankLike(WindowFunction):
    """A function of the row's place in its partition alone."""

    def __init__(self):
        self.children = []

    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False


class RowNumber(_RankLike):
    pass


class Rank(_RankLike):
    pass


class DenseRank(_RankLike):
    pass


class PercentRank(_RankLike):
    """(rank - 1) / (partition rows - 1); 0.0 for a 1-row partition."""

    def dtype(self):
        return T.FLOAT64


class CumeDist(_RankLike):
    """Rows up to the current row's last peer over partition rows."""

    def dtype(self):
        return T.FLOAT64


class NTile(_RankLike):
    """Spark's ``ntile(n)``: the first ``rows % n`` buckets hold one row
    more than the others."""

    def __init__(self, n: int):
        if not isinstance(n, int) or isinstance(n, bool) or n <= 0:
            raise ValueError(f"ntile requires a positive bucket count, "
                             f"got {n!r}")
        super().__init__()
        self.n = n

    def __repr__(self):
        return f"ntile({self.n})"


class _Offset(WindowFunction):
    """``lead`` / ``lag``: the source ``offset`` rows after / before in
    the partition's order, NULL past the partition's edge.  There is no
    default value: the reference's ignores its default and answers NULL,
    which is not Spark's answer, so SQL text with a non-NULL default
    raises ``SqlError`` (``api/sql.py``)."""

    def __init__(self, child: Expression, offset: int = 1):
        self.children = [child]
        self.offset = int(offset)

    def dtype(self):
        return self.children[0].dtype()

    def __repr__(self):
        return f"{self.name.lower()}({self.children[0]!r}, {self.offset})"


class Lead(_Offset):
    pass


class Lag(_Offset):
    pass
