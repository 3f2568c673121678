"""Census of the TPC-DS texts the port's SQL runs, on the CPU.

Writes ``benchmarks/tpcds.generate``'s tables at a small scale, registers
them on a port session (``device="cpu"``) and runs each of the 99
``benchmarks/tpcds_queries`` texts through ``session.sql(text)
.to_arrow()``.  Prints one line per query (``ok`` with its rows, or the
first refusal), then how many run and each refusal's count:

    python sql_census.py                  # scale 0.02, seed 11
    python sql_census.py --scale 0.02 --seed 11 --dir /tmp/census
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def refusal(err: Exception) -> str:
    """The refusal without its position in the text."""
    msg = re.sub(r"\s*\(at \d+\)|,? got .* at \d+$|: .*$", "", str(err))
    return f"{type(err).__name__}: {msg}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--dir", default=None,
                    help="where the tables go (a temporary directory if "
                         "not given)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    import torch
    import tpcds
    from tpcds_queries import QUERIES
    from spark_rapids_tpu_torch.api import TpuSession
    torch.set_num_threads(1)

    with tempfile.TemporaryDirectory(prefix="census_") as tmp:
        data_dir = args.dir or tmp
        if not os.path.exists(os.path.join(data_dir, "store_sales.parquet")):
            tpcds.generate(data_dir, scale=args.scale, seed=args.seed)
        session = TpuSession(device="cpu")
        tpcds.register(session, data_dir)
        ran, refused = [], collections.Counter()
        names = sorted(QUERIES, key=lambda q: int(q[1:].rstrip("ab")))
        for q in names:
            try:
                rows = session.sql(QUERIES[q]).to_arrow().num_rows
            except Exception as err:           # noqa: BLE001 (the census)
                refused[refusal(err)] += 1
                print(f"{q}: {refusal(err)}", flush=True)
                continue
            ran.append(q)
            print(f"{q}: ok, {rows} rows", flush=True)
    print(f"{len(ran)} of {len(names)} texts run: {' '.join(ran)}")
    for why, n in refused.most_common():
        print(f"  {n:3d}  {why}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
