"""greptimedb_tpu_torch: the PyTorch/CUDA port of greptimedb_tpu.

The JAX package (``greptimedb_tpu``) stays the reference; this package
keeps its module paths and names so each counterpart is found at once,
and runs the device work as torch tensor code plus hand-written CUDA
kernels (``ops/grid_kernels.py``, ``ops/promql_kernels.py`` and
``csrc/``) for NVIDIA Hopper.

Ported so far, behind ``standalone.GreptimeDB``: the SQL dense-grid
aggregation path end to end (region write/flush → resident
``GridTable`` → ``Executor.execute_grid`` → result shaping) and the
PromQL path (resident ``DeviceTable`` → sort layout → window statistics
and rate → group merge, through ``TQL EVAL`` and
``promql.engine.PromEvaluator``).  Everything else raises
``Unsupported("… not ported yet")``.

Device rule (``device.py``): entry points run on the CUDA card unless the
caller asks for the CPU; there is no silent fallback.
"""

__version__ = "0.1.0"
