"""PromQL engine of the port: Prometheus query language over torch tensors
and the hand-written CUDA kernels of ``ops/promql_kernels.py``.

Counterpart of the reference's ``greptimedb_tpu/promql/``: the range-vector
pipeline runs window boundaries by composite-key binary search over a
presorted resident layout, rate/increase by a counter-reset-adjusted f64
prefix scan, and cross-series aggregation by a series→group merge.
"""

from greptimedb_tpu_torch.promql.parser import parse_promql

__all__ = ["parse_promql"]
