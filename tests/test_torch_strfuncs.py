"""The string function library, general LIKE, ``md5``, ``rand`` and the
casts to and from STRING through the PyTorch port, on the CPU.

One seeded table (``TABLE``: strings with NULLs, empty strings, spaces at
either end, multi-byte UTF-8 and the LIKE wildcards as text; number, DATE
and BOOL columns) goes through the port (``device="cpu"``, small batches
over two partitions) and through the JAX package's engine.  Each API runs
once per engine and one test per column compares it (``LIB_COLUMNS``,
``CAST_COLUMNS``), rows by ``id``.  Where the reference departs from
Spark, the port is held to Spark's answer worked out by hand and the
reference's own answer is a ``test_reference_*`` case.  General LIKE is
held to Python's ``re`` on random patterns through ``like_match``'s plain
version; the float layout and round trip to Java's ``Double.toString`` /
``Float.toString`` on random bit patterns.  TPC-H Q13, Q16 and Q22 run on
``chip_smoke.make_tpch17``'s tables at a small scale against the JAX
engine and the pyarrow references of phase 17.
"""
import functools
import hashlib
import math
import os
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
from spark_rapids_tpu_torch.api import TpuSession, functions as F
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.kernels import cuda_ops
from spark_rapids_tpu_torch.kernels import numtext

from tests.harness import DEFAULT_FLOAT_REL, _compare_rows
from tests.jax_reference import with_cpu_session, with_tpu_session

torch.set_num_threads(1)

BATCH = "spark.rapids.tpu.sql.batchSizeRows"
WORDS = ["", " ", "  padded  ", "Music", "héllo wörld", "aaa aa", "x_y%z",
         "fu ious", "furious", "Électronique", "ab ab ab", "  ", "ly_the",
         "the other", "12", "-3.5", "1.9", "2020-01-05", "true", "ü"]


def _table(n: int = 120, seed: int = 31) -> pa.Table:
    rng = np.random.default_rng(seed)

    def nulls(v, share=0.1):
        v = np.array(v, dtype=object)
        v[rng.random(n) < share] = None
        return list(v)
    s = rng.choice(np.array(WORDS, dtype=object), n)
    s[:len(WORDS)] = WORDS
    ascii_words = [w for w in WORDS if w.isascii()]
    return pa.table({
        "id": pa.array(np.arange(n), pa.int64()),
        "s": pa.array(nulls(s), pa.string()),
        "t": pa.array(nulls(rng.choice(np.array(WORDS, dtype=object), n)),
                      pa.string()),
        "a": pa.array(nulls(rng.choice(np.array(ascii_words, dtype=object),
                                       n)), pa.string()),
        "n": pa.array(nulls(rng.integers(-10 ** 9, 10 ** 9, n)), pa.int64()),
        "x": pa.array(nulls(np.round(rng.standard_normal(n) * 1000, 3)),
                      pa.float64()),
        "d": pa.array(nulls(rng.integers(-3000, 30000, n)), pa.int32())
        .cast(pa.date32()),
        "b": pa.array(nulls(rng.random(n) < 0.5), pa.bool_()),
    })


TABLE = _table()


def _port(parts=2, rows=16):
    s = TpuSession(TpuConf({BATCH: rows}), device="cpu")
    s.create_dataframe(TABLE, num_partitions=parts) \
        .create_or_replace_temp_view("t")
    return s


@functools.lru_cache(maxsize=None)
def _jax(sql):
    def run(session):
        session.create_dataframe(TABLE, num_partitions=2) \
            .create_or_replace_temp_view("t")
        return session.sql(sql).collect()
    return with_tpu_session(run)


@functools.lru_cache(maxsize=None)
def _port_rows(sql):
    return _port().sql(sql).collect()


#: the library where the reference agrees with Spark: name -> SQL
LIB_COLUMNS = {
    "length": "length(s)", "char_length": "char_length(s)",
    "trim": "trim(s)", "ltrim": "ltrim(s)", "rtrim": "rtrim(s)",
    "reverse": "reverse(s)", "initcap": "initcap(a)",
    "instr": "instr(s, 'a')", "instr_multibyte": "instr(s, 'ö')",
    "locate": "locate('ab', s)", "concat_ws": "concat_ws('|', s, t)",
    "concat_ws_literal": "concat_ws('-', s, 'k', t)",
    "replace": "replace(s, 'a', 'XY')", "replace_overlapping":
    "replace(s, 'aa', 'b')", "replace_empty": "replace(s, '', 'z')",
    "repeat": "repeat(s, 3)",
    "repeat_zero": "repeat(s, 0)", "lpad": "lpad(s, 7, '*')",
    "lpad_multibyte": "lpad(s, 9, 'éa')", "rpad": "rpad(s, 4, '.')",
    "rpad_space": "rpad(s, 12)", "md5": "md5(s)",
    "like_one": "s like 'fu_ious'", "like_inner": "s like '%l%o%'",
    "like_escape": "s like '%\\_%'", "like_multibyte": "s like '_llo%'",
    "not_like": "s not like '%a_a%'", "upper_initcap": "upper(initcap(a))",
}


def _by_id(rows):
    return sorted(rows, key=lambda r: r[0])


@pytest.mark.parametrize("name", list(LIB_COLUMNS))
def test_string_library_against_jax(name):
    """Each function of the library, row for row, as the JAX engine
    computes it (on the device or in its host loops)."""
    sql = f"select id, {LIB_COLUMNS[name]} from t"
    assert _by_id(_port_rows(sql)) == _by_id(_jax(sql))


def test_string_library_by_hand():
    """Spark's answers worked out by hand, multi-byte characters and
    NULLs included."""
    s = _port()
    rows = s.sql(
        "select length('héllo'), trim('  a b  '), reverse('héllo'), "
        "instr('héllo wörld', 'ö'), locate('l', 'héllo', 4), "
        "locate('l', 'héllo', 0), locate('', 'abc', 9), "
        "lpad('héllo', 3, '*'), lpad('ab', 6, 'éa'), rpad('ab', 0, 'x'), "
        "repeat('ab', -1), replace('aaaa', 'aa', 'b'), "
        "replace('ababa', 'aba', 'X'), initcap(' x-ray  yes'), "
        "concat_ws('/', 'a', null, 'b'), concat_ws(null, 'a'), "
        "md5(''), length(null), replace('hello', 'l') from t where id = "
        "0").collect()
    assert rows == [(5, "a b", "olléh", 8, 4, 0, 1, "hél", "éaéaab", "",
                     "", "bb", "Xba", " X-ray  Yes", "a/b", None,
                     hashlib.md5(b"").hexdigest(), None, "heo")]


def test_greatest_least_of_strings_by_hand():
    """``greatest`` / ``least`` of strings in byte order, NULLs skipped
    (Spark's answer; the reference raises)."""
    rows = _port().sql(
        "select greatest('b', 'ab', null), least('b', 'ab', null), "
        "greatest('é', 'z'), least(null, 'q'), greatest(s, t) g, "
        "least(s, t) l, s, t from t").collect()
    assert rows[0][:4] == ("b", "ab", "é", "q")
    for r in rows:
        vals = [v for v in r[6:] if v is not None]
        assert r[4] == (max(vals, key=lambda v: v.encode()) if vals
                        else None)
        assert r[5] == (min(vals, key=lambda v: v.encode()) if vals
                        else None)


def test_reference_greatest_of_strings_raises():
    """The JAX package's fault: its ``greatest`` of strings raises where
    Spark (and the port) answer the largest string."""
    with pytest.raises(Exception):
        _jax("select greatest(s, t) from t")


def test_reference_locate_ignores_position():
    """The JAX package's fault: ``locate(sub, s, pos)`` drops ``pos``
    (its ``functions.locate`` is ``instr``), so ``locate('l', 'hello',
    4)`` is 3 there and 4 in Spark and the port."""
    from spark_rapids_tpu.api import functions as JF

    def run(session):
        df = session.create_dataframe(pa.table({"s": ["hello"]}))
        return df.select(JF.locate("l", "s", 4)).collect()
    assert with_tpu_session(run) == [(3,)]
    df = _port().create_dataframe(pa.table({"s": ["hello"]}))
    assert df.select(F.locate("l", "s", 4)).collect() == [(4,)]


def _like_regex(pattern: str, escape: str = "\\") -> str:
    out, chars = [], iter(pattern)
    for ch in chars:
        if ch == escape:
            out.append(re.escape(next(chars)))
        elif ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def test_like_match_plain_against_python_re():
    """Random patterns over ``%``, ``_``, escapes and multi-byte
    characters against random strings of the same alphabet: the plain
    version of ``like_match`` answers as ``re.fullmatch`` of the pattern's
    regex (``_`` one character)."""
    rng = np.random.default_rng(5)
    alphabet = ["a", "b", "é", "%", "_", "ü", "\\"]
    strings = ["".join(rng.choice(alphabet, rng.integers(0, 9)))
               for _ in range(400)]
    raw = [w.encode() for w in strings]
    offsets = torch.tensor([0] + list(np.cumsum([len(r) for r in raw])),
                           dtype=torch.int32)
    data = torch.tensor(list(b"".join(raw)), dtype=torch.uint8)
    valid = torch.ones(len(raw), dtype=torch.bool)
    for _ in range(120):
        pat = "".join(rng.choice(["a", "b", "é", "%", "_", "\\%", "\\_",
                                  "\\\\", "ü"], rng.integers(0, 6)))
        got = cuda_ops.like_match_plain(offsets, data, valid,
                                        cuda_ops.like_tokens(pat))
        rx = re.compile(_like_regex(pat), re.DOTALL)
        want = [rx.fullmatch(w) is not None for w in strings]
        assert got.tolist() == want, pat


def test_like_pattern_ending_in_escape_raises():
    from spark_rapids_tpu_torch.api.sql import SqlError
    with pytest.raises(SqlError, match="escape"):
        _port().sql("select s like 'ab\\' from t")


def test_like_escape_clause():
    rows = _port().sql("select count(*) from t where s like '%!_%' escape "
                       "'!'").collect()
    assert rows == [(sum(1 for w in TABLE["s"].to_pylist()
                         if w is not None and "_" in w),)]


def _java_layout(digits: str, e: int, negative: bool) -> str:
    s = "-" if negative else ""
    if -3 <= e < 7:
        if e >= 0:
            return s + digits[:e + 1].ljust(e + 1, "0") + "." + \
                (digits[e + 1:] or "0")
        return s + "0." + "0" * (-e - 1) + digits
    return s + digits[0] + "." + (digits[1:] or "0") + "E" + str(e)


def _java_double(x: float) -> str:
    if x != x:
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0:
        return "-0.0" if math.copysign(1, x) < 0 else "0.0"
    d = repr(abs(x))
    mant, _, ex = d.partition("e")
    whole, _, frac = mant.partition(".")
    ds = (whole + frac)
    lead = len(ds) - len(ds.lstrip("0"))
    return _java_layout(ds.strip("0"), int(ex or 0) + len(whole) - 1 - lead,
                        x < 0)


def test_float_text_round_trip_and_layout():
    """Random double bit patterns (subnormals, both zeros, NaN and the
    infinities among them) are laid out as Java's ``Double.toString``
    with the shortest digits (``format_double``'s plain version) and read
    back bit for bit (``parse_double``'s); floats likewise through
    float32."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2 ** 64 - 1, 3000, dtype=np.uint64,
                     endpoint=True).view(np.float64).copy()
    x[:12] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, 1e7, 1e-3,
              9.999999999999999e-4, 1e16, 0.285, 1234567.0]
    valid = torch.ones(x.shape[0], dtype=torch.bool)
    col = numtext.format_float(torch.from_numpy(x), valid)
    o, d = col.offsets.tolist(), bytes(col.data.tolist())
    texts = [d[o[i]:o[i + 1]].decode() for i in range(x.shape[0])]
    assert texts == [_java_double(v) for v in x.tolist()]
    back, ok = numtext.parse_float(col, False)
    assert ok.all()
    fin = ~np.isnan(x)
    assert np.array_equal(back.numpy().view(np.int64)[fin],
                          x.view(np.int64)[fin])
    f = x.astype(np.float32)
    fcol = numtext.format_float(torch.from_numpy(f), valid)
    fback, fok = numtext.parse_float(fcol, True)
    ffin = ~np.isnan(f)
    assert fok.all() and np.array_equal(fback.numpy().view(np.int32)[ffin],
                                        f.view(np.int32)[ffin])


#: casts where the reference's CPU oracle agrees with Spark: name ->
#: (SQL, the rows it holds: the oracle reads '1.9' as no int and '' as
#: 1970-01-01, and its engine's casts to STRING stop at its transfer guard)
CAST_COLUMNS = {
    "bigint_text": ("cast(n as string)", "1 = 1"),
    "date_text": ("cast(d as string)", "1 = 1"),
    "bool_text": ("cast(b as string)", "1 = 1"),
    "decimal_text": ("cast(cast(x as decimal(12, 3)) as string)", "1 = 1"),
    "text_double": ("cast(s as double)", "1 = 1"),
    "text_bigint": ("cast(t as bigint)", "t not like '%.%'"),
    "text_boolean": ("cast(s as boolean)", "1 = 1"),
    "text_date": ("cast(s as date)", "s like '____-__-__'"),
    "bigint_round_trip": ("cast(cast(n as string) as bigint)", "1 = 1"),
    "double_round_trip": ("cast(cast(x as string) as double)", "1 = 1"),
}


@functools.lru_cache(maxsize=None)
def _oracle(sql):
    def run(session):
        session.create_dataframe(TABLE, num_partitions=2) \
            .create_or_replace_temp_view("t")
        return session.sql(sql).collect()
    return with_cpu_session(run)


@pytest.mark.parametrize("name", list(CAST_COLUMNS))
def test_casts_against_the_oracle(name):
    """The casts to and from STRING whose answers the reference's CPU
    oracle shares with Spark, row for row."""
    expr, where = CAST_COLUMNS[name]
    sql = f"select id, {expr} from t where {where}"
    _compare_rows(_by_id(_oracle(sql)), _by_id(_port_rows(sql)),
                  rel=DEFAULT_FLOAT_REL)


@pytest.mark.parametrize("sql,spark,reference,engine", [
    ("cast('1.9' as int)", "1", None, _jax),
    ("cast('2020-1-5' as date)", "2020-01-05", None, _jax),
    ("cast(10000000.0 as string)", "1.0E7", "10000000.0", _oracle),
    ("cast(1e16 as string)", "1.0E16", "1e+16", _oracle),
    ("cast('12345678901234.567' as decimal(17, 3))", "12345678901234.567",
     "12345678901234.566", _jax),
], ids=["fraction_to_int", "short_date", "1e7", "1e16", "17_digits"])
def test_reference_cast_string_differs(sql, spark, reference, engine):
    """The casts where the JAX package departs from Spark: the port gives
    Spark's answer (worked out by hand) and the reference its own
    (``int(s)``, ``np.datetime64``, ``repr`` and ``float(s) * 10^scale``;
    a cast to STRING through its CPU oracle, since its engine's host loop
    stops at its transfer guard)."""
    text = f"select {sql} as v from t where id = 0"

    def show(v):
        return None if v is None else str(v)
    assert show(_port().sql(text).collect()[0][0]) == spark
    assert show(engine(text)[0][0]) == reference


def test_casts_from_text_by_hand():
    """Spark's non-ANSI answers, worked out by hand, for padded, signed,
    fractional and malformed text."""
    q = ("select cast(' 12 ' as int), cast('-1.9' as bigint), cast('+.' as "
         "int), cast('2147483648' as int), cast('-9223372036854775808' as "
         "bigint), cast('1e3' as int), cast(' -Infinity ' as double), "
         "cast('nan' as double), cast('1.5d' as double), cast('0x10' as "
         "double), cast('1.005' as decimal(5, 2)), cast('-0.125' as "
         "decimal(5, 2)), cast('1e2' as decimal(5, 2)), cast('99999.995' "
         "as decimal(7, 2)), cast('2020-02-30' as date), cast('2020-01-05 "
         "junk' as date), cast('2020-01' as date), cast(' Yes ' as "
         "boolean), cast('no' as boolean), cast('2' as boolean), "
         "cast(1 = 1 as string), cast(cast(-5 as decimal(5, 2)) as string), "
         "cast(cast('0001-02-03' as date) as string), cast(cast(-0.0 as "
         "float) as string), cast(cast(3.4028235e38 as float) as string) "
         "from t where id = 0")
    import datetime
    from decimal import Decimal
    row = _port().sql(q).collect()[0]
    assert row[:6] == (12, -1, 0, None, -(1 << 63), None)
    assert row[6] == -math.inf and math.isnan(row[7]) and row[8] == 1.5
    assert row[9] is None
    assert row[10:14] == (Decimal("1.01"), Decimal("-0.13"),
                          Decimal("100.00"), None)
    assert row[14:17] == (None, datetime.date(2020, 1, 5),
                          datetime.date(2020, 1, 1))
    assert row[17:20] == (True, False, None)
    assert row[20:] == ("true", "-5.00", "0001-02-03", "-0.0", "3.4028235E38")


def test_sum_of_a_string_is_the_sum_of_its_doubles():
    """``sum`` / ``avg`` of a string add its values cast to double, a word
    that is no number NULL (Spark's implicit cast)."""
    got = _port().sql("select sum(s), avg(s), count(s) from t").collect()
    vals = [float(w) for w in TABLE["s"].to_pylist()
            if w is not None and re.fullmatch(r"\s*-?\d+(\.\d*)?\s*", w)]
    assert got[0][0] == pytest.approx(sum(vals), rel=1e-12)
    assert got[0][1] == pytest.approx(sum(vals) / len(vals), rel=1e-12)


def test_md5_against_hashlib():
    """MD5 of every row's UTF-8 bytes, rows of 0 to 200 bytes (one to
    four 64-byte blocks), as hashlib's lowercase hex."""
    words = ["", "a", "é" * 27, "x" * 55, "x" * 56, "y" * 64, "z" * 119,
             "w" * 120, "q" * 200, None]
    s = TpuSession(device="cpu")
    df = s.create_dataframe(pa.table({"w": words}))
    got = [r[0] for r in df.select(F.md5("w")).collect()]
    assert got == [None if w is None else
                   hashlib.md5(w.encode()).hexdigest() for w in words]


def test_rand_is_uniform_and_does_not_depend_on_the_batch():
    """``rand(seed)``: values in [0, 1), near uniform (a Kolmogorov-
    Smirnov distance under 0.02 over 20,000 rows), the same for any batch
    size, another stream for another seed (the reference's threefry
    stream is another generator: compared by distribution)."""
    t = pa.table({"k": np.arange(20_000)})

    def draw(rows, seed=3):
        s = TpuSession(TpuConf({BATCH: rows}), device="cpu")
        df = s.create_dataframe(t, num_partitions=2)
        return np.array([r[0] for r in df.select(F.rand(seed)).collect()])
    a, b = draw(1024), draw(4096)
    assert np.array_equal(a, b)
    assert ((a >= 0) & (a < 1)).all()
    ks = np.max(np.abs(np.sort(a) - (np.arange(a.shape[0]) + 0.5) /
                       a.shape[0]))
    assert ks < 0.02
    assert not np.array_equal(a, draw(1024, seed=4))

    def run(session):
        from spark_rapids_tpu.api import functions as JF
        df = session.create_dataframe(t, num_partitions=2)
        return np.array([r[0] for r in df.select(JF.rand(3)).collect()])
    ref = with_tpu_session(run)
    assert abs(ref.mean() - a.mean()) < 0.02


def test_string_library_through_the_dataframe_api():
    """The DataFrame API's names build the same expressions as SQL."""
    s = _port()
    df = s.sql("select * from t")
    got = df.select(F.length("s"), F.trim("s"), F.reverse("s"),
                    F.instr("s", "a"), F.locate("a", "s", 2),
                    F.concat_ws("|", "s", "t"), F.replace("s", "a", "b"),
                    F.repeat("s", 2), F.lpad("s", 5, "*"),
                    F.rpad("s", 5, "*"), F.initcap("a"), F.md5("s"),
                    F.col("s").substr(2, 3), F.to_date("s"),
                    F.col("s").like("%a_a%")).collect()
    want = s.sql("select length(s), trim(s), reverse(s), instr(s, 'a'), "
                 "locate('a', s, 2), concat_ws('|', s, t), replace(s, 'a', "
                 "'b'), repeat(s, 2), lpad(s, 5, '*'), rpad(s, 5, '*'), "
                 "initcap(a), md5(s), substr(s, 2, 3), to_date(s), s like "
                 "'%a_a%' from t").collect()
    assert got == want


# -- TPC-H Q13, Q16 and Q22 at a small scale -----------------------------------

TPCH_SF = 0.004


@pytest.fixture(scope="module")
def tpch17(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpch17"))
    chip_smoke.make_tpch17(d, TPCH_SF, 7)
    return d, chip_smoke.h17_references(d)


def _h17_session(d, device="cpu"):
    s = TpuSession(TpuConf({BATCH: 4096}), device=device)
    for t in ("customer", "orders", "part", "partsupp", "supplier"):
        s.read.parquet(os.path.join(d, f"{t}.parquet")) \
            .create_or_replace_temp_view(t)
    return s


@functools.lru_cache(maxsize=None)
def _jax_h17(d, q):
    def run(session):
        for t in ("customer", "orders", "part", "partsupp", "supplier"):
            session.read.parquet(os.path.join(d, f"{t}.parquet")) \
                .create_or_replace_temp_view(t)
        return session.sql(chip_smoke.H17_TEXTS[q]).collect()
    return with_tpu_session(run)


@pytest.mark.parametrize("q", ["Q13", "Q16", "Q22"])
def test_tpch_text_against_pyarrow(tpch17, q):
    """The port's rows equal phase 17's pyarrow references, ORDER BY kept
    and ties as a multiset (``chip_smoke.check_rows``)."""
    d, refs = tpch17
    table = _h17_session(d).sql(chip_smoke.H17_TEXTS[q]).to_arrow()
    chip_smoke.check_rows(q, table, refs[q], chip_smoke.H17_ORDER[q],
                          limit=len(refs[q]))
    assert table.num_rows > 0


@pytest.mark.parametrize("q", ["Q13", "Q16"])
def test_tpch_text_against_jax(tpch17, q):
    """Q13 and Q16 as the JAX engine answers them (its general LIKE runs
    a host regex), as multisets of rows."""
    d, _ = tpch17
    got = _h17_session(d).sql(chip_smoke.H17_TEXTS[q]).collect()
    _compare_rows(_jax_h17(d, q), got, rel=DEFAULT_FLOAT_REL)


def test_reference_q22_reads_unscaled_balances(tpch17):
    """The JAX package's fault 21 in Q22: its ``avg(c_acctbal)`` of a
    DECIMAL averages the unscaled ints, 100 times the balance, so no
    customer lies above it and it answers no rows where Spark (and the
    port, and pyarrow) answer one per country code."""
    d, refs = tpch17
    assert _jax_h17(d, "Q22") == []
    assert len(refs["Q22"]) > 0
