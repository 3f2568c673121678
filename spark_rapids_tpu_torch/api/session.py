"""Session: configuration, device, DataFrame creation and execution.

Counterpart of ``spark_rapids_tpu/api/session.py``.  A session runs on
one device, ``cuda`` by default; ``device="cpu"`` runs the same plans on
the CPU through each kernel's plain torch version.  ``read.parquet``
makes a DataFrame over Parquet files, ``create_or_replace_temp_view``
names it, and ``sql`` runs query text over the named views
(``api/sql.py``).  Building a session sizes the process's device memory
plane for its device and conf (``memory/arena.DeviceManager``); a
collect holds a device permit, closes the plan (no catalog entry
outlives it) and keeps the catalog's movements during the query in
``last_query_memory``.
"""
from __future__ import annotations

from typing import Dict, Optional

import pyarrow as pa

from ..columnar.arrow import empty_table, to_arrow
from ..config import TpuConf, resolve_device
from ..exec.tpu_basic import TpuExec
from ..memory.arena import DeviceManager
from ..memory.catalog import BufferCatalog
from ..plan import logical as L
from ..plan.overrides import plan_physical


#: catalog counters a collect reports (``last_query_memory``)
QUERY_MEMORY_KEYS = ("spilled_device_to_host", "spilled_host_to_disk",
                     "unspills", "unspilled_bytes", "oom_retries")


class TpuSession:
    def __init__(self, conf: Optional[TpuConf] = None, device="cuda"):
        self.conf = conf if conf is not None else TpuConf()
        self.device = resolve_device(device)
        self.last_physical_plan: Optional[TpuExec] = None
        #: the catalog's counters moved by the last collect
        self.last_query_memory: Dict[str, int] = {}
        self._views: Dict[str, L.LogicalPlan] = {}
        DeviceManager.initialize(self.conf, self.device)

    @property
    def read(self):
        from .reader import DataFrameReader
        return DataFrameReader(self)

    def register_table(self, name: str, df) -> None:
        self._views[name.lower()] = df._plan

    def sql(self, query: str):
        """A DataFrame of the query over this session's temp views;
        ``SqlError`` if the text holds a construct the port does not
        run.  Its uncorrelated subqueries run here, on this session's
        device."""
        from .dataframe import DataFrame
        from .sql import sql_to_plan
        return DataFrame(sql_to_plan(query, self._views, self), self)

    def create_dataframe(self, data, num_partitions: int = 1):
        from .dataframe import DataFrame
        if isinstance(data, dict):
            table = pa.table({k: pa.array(v) for k, v in data.items()})
        elif isinstance(data, pa.Table):
            table = data
        else:
            raise TypeError(f"cannot create a dataframe from {type(data)}")
        return DataFrame(L.LocalRelation(table, num_partitions), self)

    def plan(self, logical: L.LogicalPlan) -> TpuExec:
        return plan_physical(logical, self.conf, self.device)

    def execute_to_arrow(self, logical: L.LogicalPlan) -> pa.Table:
        physical = self.plan(logical)
        self.last_physical_plan = physical
        sem = DeviceManager.get().semaphore
        cat = BufferCatalog.get()
        before = cat.stats()
        sem.acquire_if_necessary()
        try:
            tables = [to_arrow(b) for part in physical.execute()
                      for b in part]
        finally:
            physical.close()
            sem.release()
            after = cat.stats()
            self.last_query_memory = {k: after[k] - before[k]
                                      for k in QUERY_MEMORY_KEYS}
        tables = [t for t in tables if t.num_rows]
        if not tables:
            return empty_table(physical.output_schema)
        return pa.concat_tables(tables)
