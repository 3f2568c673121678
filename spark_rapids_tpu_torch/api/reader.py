"""DataFrameReader: DataFrames over Parquet files.

Counterpart of ``spark_rapids_tpu/api/reader.py`` (Parquet only).  A
path is a file or a directory of part files; the schema is the first
file's, and its columns of types the port does not carry stay in it
until a query reads them (which raises).
"""
from __future__ import annotations

from ..io.readers import infer_schema
from ..plan import logical as L


class DataFrameReader:
    def __init__(self, session):
        self.session = session

    def parquet(self, *paths: str):
        from .dataframe import DataFrame
        return DataFrame(L.Scan(list(paths), infer_schema(list(paths))),
                         self.session)
