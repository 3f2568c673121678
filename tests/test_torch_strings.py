"""String columns of the PyTorch port against the JAX package, on the CPU.

The same seeded strings go through both packages: the Arrow round trip
with nulls, the key words and their width (bit-equal), gathers, the sort
order of string keys, and the partition id of a string, which in the
port does not depend on the batch the string arrives in.  ``substring``
of non-ASCII strings counts characters, as the JAX package's oracle and
Spark do; its engine counts bytes and cuts a UTF-8 character.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import arrow as jarrow
from spark_rapids_tpu.columnar.column import StringColumn as JStringColumn
from spark_rapids_tpu.expr import core as jec
from spark_rapids_tpu.kernels import canon as jcanon
from spark_rapids_tpu.kernels import strings as jstrings
from spark_rapids_tpu.shuffle.partitioners import \
    HashPartitioner as JHashPartitioner

from spark_rapids_tpu_torch.columnar import dtypes as T
from spark_rapids_tpu_torch.columnar.arrow import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.schema import Field, Schema
from spark_rapids_tpu_torch.expr import core as ec
from spark_rapids_tpu_torch.kernels import canon, strings
from spark_rapids_tpu_torch.kernels.sort import sort_permutation
from spark_rapids_tpu_torch.shuffle.partitioners import HashPartitioner

_ALPHABET = list("abcAB z09#") + ["é", "ß"]


def _random_strings(rng, n: int, max_len: int, null_rate: float = 0.1):
    out = []
    for _ in range(n):
        if rng.random() < null_rate:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len + 1))
        out.append("".join(rng.choice(_ALPHABET, k)))
    return out


def _port_col(values):
    return from_arrow(pa.table({"s": pa.array(values, pa.string())}),
                      "cpu").columns[0]


def _live(col, n):
    return torch.arange(col.capacity) < n


@pytest.mark.parametrize("seed", [0, 1])
def test_arrow_round_trip_with_nulls(seed):
    rng = np.random.default_rng(seed)
    values = _random_strings(rng, 300, 40, 0.2) + ["", None, "Music"]
    arr = pa.array(values, pa.string())
    for table in (pa.table({"s": arr, "i": np.arange(len(values))}),
                  pa.table({"s": arr}).slice(7, 150)):
        got = to_arrow(from_arrow(table, "cpu"))
        assert got.equals(table.select(got.column_names))
        ref = jarrow.to_arrow(jarrow.from_arrow(table))
        assert got.column("s").to_pylist() == ref.column("s").to_pylist()


@pytest.mark.parametrize("max_len", [0, 5, 8, 9, 29, 70])
def test_key_words_bit_equal(max_len):
    rng = np.random.default_rng(max_len)
    values = _random_strings(rng, 200, max_len)
    n = len(values)
    col = _port_col(values)
    jcol = JStringColumn.from_pylist(values)
    width = jstrings.needed_key_words(jcol, n)
    assert strings.needed_key_words(col) == width
    for nw in sorted({width, 2 * width}):
        got = strings.string_key_words(col, nw)
        want = jstrings.string_key_words(jcol, n, num_words=nw)
        assert len(got) == len(want) == nw + 1
        for g, w in zip(got, want):
            w = np.asarray(w)[:n]
            valid = np.array([v is not None for v in values])
            # null rows' bytes are not defined by either package
            np.testing.assert_array_equal(
                g[:n].numpy().view(np.uint64)[valid], w.astype(np.uint64)[
                    valid])


@pytest.mark.parametrize("descending,nulls_last", [(False, False),
                                                   (True, True),
                                                   (False, True),
                                                   (True, False)])
def test_column_key_words_match_reference(descending, nulls_last):
    rng = np.random.default_rng(3)
    values = _random_strings(rng, 150, 20, 0.15)
    n = len(values)
    col = _port_col(values)
    jcol = JStringColumn.from_pylist(values)
    got = canon.column_key_words(col, _live(col, n), descending=descending,
                                 nulls_last=nulls_last)
    want = jcanon.column_key_words(jcol, n, descending=descending,
                                   nulls_last=nulls_last)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:n].numpy().view(np.uint64),
                                      np.asarray(w)[:n].astype(np.uint64))


def test_gather_strings():
    rng = np.random.default_rng(5)
    values = _random_strings(rng, 64, 25, 0.2)
    col = _port_col(values)
    idx = rng.integers(0, len(values), 100)
    live = np.arange(100) < 90
    got = strings.gather_strings(col, torch.from_numpy(idx),
                                 torch.from_numpy(live))
    jcol = JStringColumn.from_pylist(values)
    offs, buf, valid = jstrings.gather_strings(
        jcol.offsets, jcol.data, jcol.validity, idx, live=live)
    ref = JStringColumn(offs, buf, valid).to_pylist(100)
    batch = ColumnarBatch(Schema([Field("s", T.STRING)]), [got], 100)
    out = to_arrow(batch).column("s").to_pylist()
    assert out == ref
    want = [values[i] if ok else None for i, ok in zip(idx, live)]
    assert out == want


def _sorted_values(values, descending, nulls_last, width=None):
    col = _port_col(values)
    words = canon.batch_key_words([col], _live(col, len(values)),
                                  descending=[descending],
                                  nulls_last=[nulls_last], str_words=[width])
    perm = sort_permutation(words)[:len(values)].tolist()
    return [values[i] for i in perm]


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_last", [False, True])
def test_string_sort_order(descending, nulls_last):
    base = ["b", "", "ab", "a", None, "abc", "ab", "abd", "a" * 17,
            "a" * 16, "B", "é", "z", None, "", "ab"]
    rng = np.random.default_rng(7)
    values = base + _random_strings(rng, 200, 12, 0.1)
    raw = [v.encode() if v is not None else b"" for v in values]
    # sorted() is stable, also with reverse=True: ties keep input order
    nonnull = sorted((i for i, v in enumerate(values) if v is not None),
                     key=lambda i: raw[i], reverse=descending)
    nulls = [i for i, v in enumerate(values) if v is None]
    want_idx = nonnull + nulls if nulls_last else nulls + nonnull
    want = [values[i] for i in want_idx]
    assert _sorted_values(values, descending, nulls_last) == want
    # a wider agreed width gives the same order
    assert _sorted_values(values, descending, nulls_last, width=8) == want


def _port_ids(values, parts=8):
    batch = from_arrow(pa.table({"k": pa.array(values, pa.string())}), "cpu")
    part = HashPartitioner([ec.AttributeReference("k", T.STRING)], parts)
    split = part.split(batch)
    ids = {}
    for pid in range(parts):
        s = split.partition_slice(pid)
        if s is not None:
            for v in to_arrow(s).column("k").to_pylist():
                ids.setdefault(v, set()).add(pid)
    return ids


def _reference_id(values, key="Music", parts=8):
    jbatch = jarrow.from_arrow(pa.table({"k": pa.array(values, pa.string())}))
    part = JHashPartitioner([jec.AttributeReference("k")], parts)
    ids = np.asarray(part.partition_ids(jbatch))
    return int(ids[values.index(key)])


_BATCHES = [["Music", "Books"], ["Music", "Electronics"],
            ["Music", "x" * 29], ["Music", "y" * 70, None, ""]]


def test_string_partition_id_is_independent_of_the_batch():
    ids = [_port_ids(b)["Music"] for b in _BATCHES]
    assert all(len(i) == 1 for i in ids)
    assert len(set.union(*ids)) == 1
    # every string lands in one partition when the batches are mixed
    rng = np.random.default_rng(11)
    pool = _random_strings(rng, 50, 40, 0.0)
    seen = {}
    for k in range(6):
        batch = list(rng.choice(pool, 30)) + ["z" * (8 << k)]
        for v, pids in _port_ids(batch).items():
            seen.setdefault(v, set()).update(pids)
    assert all(len(p) == 1 for p in seen.values())


def test_reference_string_partition_id_depends_on_the_batch():
    """The reference hashes the key words at the batch's width, so one
    string goes to different partitions in different batches (its fault,
    not the port's)."""
    assert [_reference_id(b) for b in _BATCHES[:3]] == [5, 7, 0]


_UNICODE = ["héllo", "日本語テキスト", "abc", None, "", "ñandú", "x", "ß",
            "Électronique", "naïve café"]


def _substrings(F, s):
    df = s.create_dataframe(pa.table({
        "k": pa.array(range(len(_UNICODE)), pa.int64()),
        "s": pa.array(_UNICODE, pa.string())}), num_partitions=2)
    return df.select(F.col("k"), *[
        F.substring(F.col("s"), pos, n).alias(f"s{i}")
        for i, (pos, n) in enumerate([(1, 2), (2, 100), (0, 4), (-3, 2),
                                      (3, 1), (-100, 3), (5, 0)])]
    ).collect()


def test_substring_of_non_ascii_strings_matches_oracle():
    """Positions and lengths count characters: substring('héllo', 1, 2) is
    'hé', every result decodes (collect raises nothing), and every row
    equals the JAX package's oracle."""
    from spark_rapids_tpu.api import functions as JF
    from spark_rapids_tpu_torch.api import TpuSession
    from spark_rapids_tpu_torch.api import functions as PF
    from tests.jax_reference import with_cpu_session
    got = sorted(_substrings(PF, TpuSession(device="cpu")))
    want = sorted(with_cpu_session(lambda s: _substrings(JF, s)))
    assert got == want
    assert got[0][1] == "hé" and got[1][1] == "日本"
    assert got[1][4] == "キス"


def test_reference_substring_cuts_a_character():
    """The JAX package's fault (ROADMAP C): its engine's substring counts
    bytes, so substring('héllo', 1, 2) keeps 'h' and the first byte of
    'é', which decodes as U+FFFD."""
    from spark_rapids_tpu.api import functions as JF
    from tests.jax_reference import with_tpu_session
    rows = sorted(with_tpu_session(lambda s: _substrings(JF, s)))
    assert rows[0][1] == "h\ufffd"
