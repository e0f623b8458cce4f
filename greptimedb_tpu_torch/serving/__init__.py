"""Concurrent serving layer: async query scheduler, per-tenant admission
and cross-query batched dispatch.

The production front door every protocol server (servers/http.py,
mysql.py, postgres.py over servers/tcp.py) submits queries through
instead of executing inline (ROADMAP Open item 1; Theseus,
arXiv 2508.05029: at scale the win is scheduling compute and data
movement *across* queries, not inside one).  ``GREPTIME_SCHEDULER=off``
restores the inline path byte-for-byte — the package is not even
imported then.
"""

from greptimedb_tpu_torch.serving.admission import TenantAdmission, TenantQuota
from greptimedb_tpu_torch.serving.scheduler import QueryScheduler

__all__ = ["QueryScheduler", "TenantAdmission", "TenantQuota"]
