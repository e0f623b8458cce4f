"""Flow engine: continuous aggregation (reference src/flow, SURVEY.md §2.7).

Three engines behind one FlowEngine facade (flow/engine.py):

- DEVICE streaming (flow/device.py): resident ``[G, W]`` partial-state
  matrices on the device, one fold (chunk segment-reduce + state
  merge) per (flow, chunk) — the default for decomposable aggregate
  flows over plain tables;
- HOST streaming: the dict-of-partials incremental fold (the
  ``GREPTIME_FLOW_DEVICE=off`` twin and the fallback for query shapes /
  quota rejections outside the device surface);
- BATCHING: dirty-window re-query for non-decomposable queries.

All three checkpoint through flow/checkpoint.py (GTF1 envelopes + exact
WAL-offset watermarks), so a restart resumes by replaying only the WAL
tail.

Torch counterpart of the reference's ``flow`` package: the device fold
runs the ``flow_merge`` kernel (``ops/flow_kernels.py``) and the
``segment_reduce`` kernel.  Not ported yet: ``flow/cluster.py``
(flownodes), the ``flow`` memory quota and the mesh sharding of the
state.
"""
