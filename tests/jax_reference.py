"""The JAX package's engine and oracle as the port's tests run them.

``with_tpu_session`` runs ``fn`` on a JAX engine session as
``tests/harness.with_tpu_session`` does, with settings that give the same
rows for fewer XLA compiles:

- the JAX package's own smallest capacity bucket (``MIN_CAPACITY``,
  1024; its test suite pins 16, which multiplies the padded shapes each
  program compiles for);
- no superstage fusion, so the per-operator programs compiled for one
  query serve the next (``tests/test_compile.py`` holds the JAX engine's
  rows identical with fusion on and off);
- no cost or stats plane (they record compile costs and exchange
  statistics, and change no row).

Afterwards the process-wide state a session sets (the active conf, the
capacity lattice) is left as the harness would leave it, so the JAX
package's own tests that a worker runs next see no difference.
``with_cpu_session`` is the harness's oracle, unchanged.
"""
from spark_rapids_tpu.columnar import column as _column

from tests import harness
from tests.harness import with_cpu_session  # noqa: F401

MIN_CAPACITY = 1024
#: settings of the JAX engine's runs (callers' settings go on top)
QUICK = {"spark.rapids.tpu.sql.superstage": False,
         "spark.rapids.tpu.obs.cost.enabled": False,
         "spark.rapids.tpu.obs.stats.enabled": False}


def with_tpu_session(fn, conf=None):
    saved = _column.MIN_CAPACITY
    _column.MIN_CAPACITY = MIN_CAPACITY
    try:
        return harness.with_tpu_session(fn, {**QUICK, **(conf or {})})
    finally:
        _column.MIN_CAPACITY = saved
        harness.with_tpu_session(lambda s: None, conf)
