"""Storage engine: the mito2-equivalent region store (host code, copied
from the reference) plus the resident dense grid on the torch device."""

from greptimedb_tpu_torch.storage.region import Region, RegionEngine, RegionOptions

__all__ = ["RegionEngine", "Region", "RegionOptions"]
