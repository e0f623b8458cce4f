"""Mask discipline: filters, null handling, row compaction.

Torch counterpart of the reference's ``ops/masks.py``.  A WHERE clause
never removes rows — it refines a bool mask that every downstream
reduction respects; rows are compacted only at materialization
boundaries (the raw scan's download) by the ``compact`` kernel
(``ops/segment_kernels.py``), a stable stream compaction.

Dtype/empty-encoding rules live in ops.segment; masked_reduce is the
num_segments=1 case of segment_reduce.
"""

from __future__ import annotations

import torch


def valid_mask(values: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """Rows that are present AND non-null (NaN = null for floats)."""
    if values.is_floating_point():
        return row_mask & ~torch.isnan(values)
    return row_mask


def masked_reduce(values: torch.Tensor, row_mask: torch.Tensor,
                  op: str) -> torch.Tensor:
    """Whole-column reduction honoring mask/null discipline."""
    from greptimedb_tpu_torch.ops.segment import segment_reduce

    ids = torch.zeros(values.shape, dtype=torch.int32, device=values.device)
    return segment_reduce(values, ids, 1, op, row_mask)[0]


def compact_rows(columns: dict[str, torch.Tensor], row_mask: torch.Tensor
                 ) -> tuple[dict[str, torch.Tensor], int]:
    """The masked-in rows of every column, in row order; returns
    (columns, n), each column [n].  The reference keeps the full shape
    (padding rows moved to the back) because a jitted program cannot
    change it; here only the kept rows are gathered."""
    from greptimedb_tpu_torch.ops.segment_kernels import compact

    return compact(columns, row_mask)
