"""Engine data types: the fixed-width subset the port carries, dates,
and strings.

Counterpart of ``spark_rapids_tpu/columnar/dtypes.py``.  Each dtype knows
its device buffer type (a torch dtype) and its numpy/arrow types for
host interop.  Nulls travel in a separate validity mask, Arrow-style.
A string column has no single buffer type: it is int32 offsets plus
uint8 bytes (``columnar/column.StringColumn``).

A DATE is the reference's ``DateType``: int32 days since 1970-01-01 on
the device, arrow ``date32`` on the host.  It is neither integral nor
fractional: it compares, keys joins, group-bys and sorts (its key word is
the int32's), and takes no arithmetic.

A DECIMAL is the reference's DECIMAL64 ``DecimalType(precision,
scale)``: precision at most 18 (``MAX_PRECISION``; a wider one raises),
held as the unscaled int64 on the device and as arrow ``decimal128(p,
s)`` on the host (``columnar/arrow.py``).  It is neither integral nor
fractional; ``is_numeric`` covers all three kinds.  The arithmetic on
its unscaled values is ``kernels/decimal.py``.

A file may hold columns of a type the port does not carry (a timestamp,
say): ``from_arrow`` types them ``UnsupportedType`` so the file's schema
still reads, and reading such a column raises.
"""
from __future__ import annotations

import datetime
import decimal

import numpy as np
import pyarrow as pa
import torch


class DType:
    """Base engine dtype; instances are singletons compared by type."""

    name: str = "invalid"
    np_dtype: np.dtype = None
    torch_dtype: torch.dtype = None
    arrow_type: pa.DataType = None
    is_integral = False
    is_fractional = False
    is_decimal = False

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_fractional or self.is_decimal

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)


class BooleanType(DType):
    name = "boolean"
    np_dtype = np.dtype(np.bool_)
    torch_dtype = torch.bool
    arrow_type = pa.bool_()


class IntegerType(DType):
    name = "int"
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32
    arrow_type = pa.int32()
    is_integral = True


class LongType(DType):
    name = "bigint"
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64
    arrow_type = pa.int64()
    is_integral = True


class FloatType(DType):
    name = "float"
    np_dtype = np.dtype(np.float32)
    torch_dtype = torch.float32
    arrow_type = pa.float32()
    is_fractional = True


class DoubleType(DType):
    name = "double"
    np_dtype = np.dtype(np.float64)
    torch_dtype = torch.float64
    arrow_type = pa.float64()
    is_fractional = True


class StringType(DType):
    name = "string"
    np_dtype = np.dtype(object)
    arrow_type = pa.string()


class DateType(DType):
    """Days since 1970-01-01 as int32; a host value is a
    ``datetime.date``."""
    name = "date"
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32
    arrow_type = pa.date32()


class DecimalType(DType):
    """DECIMAL64: ``precision`` digits, ``scale`` of them after the
    point, held as the unscaled int64 ``value * 10^scale``."""
    MAX_PRECISION = 18
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64
    is_decimal = True

    def __init__(self, precision: int = 10, scale: int = 0):
        if not 0 < precision <= self.MAX_PRECISION:
            raise ValueError(f"DECIMAL precision {precision} is outside "
                             f"DECIMAL64's 1..{self.MAX_PRECISION}")
        if not 0 <= scale <= precision:
            raise ValueError(f"DECIMAL scale {scale} is outside 0.."
                             f"{precision}")
        self.precision, self.scale = int(precision), int(scale)

    @property
    def name(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    @property
    def arrow_type(self) -> pa.DataType:
        return pa.decimal128(self.precision, self.scale)

    def __eq__(self, other) -> bool:
        return isinstance(other, DecimalType) and \
            (other.precision, other.scale) == (self.precision, self.scale)

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))


class NullType(DType):
    """The type of a bare ``NULL`` literal; a conditional takes its
    result type from its other branches."""
    name = "null"
    np_dtype = np.dtype(np.bool_)
    torch_dtype = torch.bool
    arrow_type = pa.null()


class UnsupportedType(DType):
    """A column type of a file that the port does not carry; planning a
    scan that reads such a column raises."""

    def __init__(self, arrow_type: pa.DataType):
        self.arrow_type = arrow_type
        self.name = f"unsupported<{arrow_type}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, UnsupportedType) and \
            other.arrow_type == self.arrow_type

    def __hash__(self) -> int:
        return hash(("unsupported", str(self.arrow_type)))


BOOL = BooleanType()
INT32 = IntegerType()
INT64 = LongType()
FLOAT32 = FloatType()
FLOAT64 = DoubleType()
STRING = StringType()
DATE = DateType()
NULL = NullType()

_ALL = (BOOL, INT32, INT64, FLOAT32, FLOAT64)
_NUMERIC_ORDER = [INT32, INT64, FLOAT32, FLOAT64]


def from_numpy(dt) -> DType:
    dt = np.dtype(dt)
    for t in _ALL:
        if t.np_dtype == dt:
            return t
    raise NotImplementedError(f"no engine dtype for numpy {dt}")


def from_arrow(at: pa.DataType, lenient: bool = False) -> DType:
    """The engine dtype of an arrow type.  An arrow type the port does not
    carry raises, or with ``lenient`` (a file's schema) types as
    ``UnsupportedType``."""
    for t in _ALL + (DATE,):
        if t.arrow_type == at:
            return t
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_decimal128(at) and \
            at.precision <= DecimalType.MAX_PRECISION:
        return DecimalType(at.precision, at.scale)
    if pa.types.is_decimal(at) and not lenient:
        raise ValueError(f"{at}: DECIMAL64 holds at most "
                         f"{DecimalType.MAX_PRECISION} digits")
    if lenient:
        return UnsupportedType(at)
    raise NotImplementedError(f"no engine dtype for arrow {at}")


def unscaled_of(value, scale: int) -> int:
    """The unscaled int of a host number at ``scale`` (HALF_UP); a float
    goes by its shortest repr, as its SQL text reads."""
    d = value if isinstance(value, decimal.Decimal) else \
        decimal.Decimal(repr(value) if isinstance(value, float) else value)
    return int(d.scaleb(scale).to_integral_value(decimal.ROUND_HALF_UP))


def wider_decimal(a: DecimalType, b: DecimalType) -> DecimalType:
    """Spark's ``widerDecimalType``: the larger scale and the larger
    count of integer digits, capped at 18 digits (the scale kept)."""
    scale = max(a.scale, b.scale)
    whole = max(a.precision - a.scale, b.precision - b.scale)
    return DecimalType(min(whole + scale, DecimalType.MAX_PRECISION), scale)


def common_type(a: DType, b: DType) -> DType:
    """Numeric type promotion following Spark's binary-op coercion; a
    NULL side takes the other's type.  A DECIMAL with an integer takes
    the reference's answer, the DECIMAL; two DECIMALs their wider type
    (``wider_decimal``); a DECIMAL with a float is a double."""
    if a == b:
        return a
    if a == NULL or b == NULL:
        return b if a == NULL else a
    if a in _NUMERIC_ORDER and b in _NUMERIC_ORDER:
        return _NUMERIC_ORDER[max(_NUMERIC_ORDER.index(a),
                                  _NUMERIC_ORDER.index(b))]
    if a.is_decimal or b.is_decimal:
        if a.is_decimal and b.is_decimal:
            return wider_decimal(a, b)
        other = b if a.is_decimal else a
        if other.is_fractional:
            return FLOAT64
        if other.is_integral:
            return a if a.is_decimal else b
    raise ValueError(f"no common type for {a} and {b}")


#: the epoch a DATE counts its days from
EPOCH = datetime.date(1970, 1, 1)


def date_to_days(value: datetime.date) -> int:
    return (value - EPOCH).days
