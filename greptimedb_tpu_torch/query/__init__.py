"""Query engine: SQL → logical plan → torch/CUDA execution of the grid path."""

from greptimedb_tpu_torch.query.engine import QueryEngine

__all__ = ["QueryEngine"]
