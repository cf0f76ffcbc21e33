"""memo_tpu — a pangenome k-mer query engine on JAX.

A from-scratch reimplementation of the capabilities of StephenHwang/MEMO
(Maximal Exact Match Ordered pangenome indexing), designed for an
accelerator:

- The external MONI C++ dependency (reference index.sh:69-76) is replaced by an
  in-repo C++ matching-statistics library (``memo_tpu.native`` / ``libms``)
  built on a generalized suffix automaton, with a pure-Python fallback.
- The reference's file-bus pipeline (dap.txt -> BED -> Parquet,
  reference index.sh:83-109) is replaced by vectorized array transforms; the
  index is a device-resident sorted struct-of-arrays interval store
  (:mod:`memo_tpu.index.store`). BED/Parquet emitters are kept for
  byte-level compatibility with the reference on-disk formats.
- The reference's numba query loop (reference memo_query.py:57-63) is replaced
  by a dense difference-array + coverage formulation (:mod:`memo_tpu.ops`)
  that XLA compiles for the device, with a numpy twin as the host oracle.
- Multi-chip scaling is mesh-based (:mod:`memo_tpu.parallel`): query windows
  data-parallel, the position axis sequence-parallel, the interval store
  replicated or coordinate-sharded, merged with XLA collectives.

Outputs are bit-exact with the reference CLI (``memo index | query | view``).
"""

__version__ = "0.1.0"

from memo_tpu.index.store import IntervalStore  # noqa: F401
from memo_tpu.query.engine import QueryEngine  # noqa: F401
