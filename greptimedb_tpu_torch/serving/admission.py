"""Per-tenant admission control: rate, concurrency and memory quotas.

Extends the utils/memory.py workload-quota pattern to per-tenant budgets:
each tenant's in-flight working-set estimate is registered as a workload
(``tenant:<name>``) in the SHARED WorkloadMemoryManager, so tenant memory
pressure surfaces through the same reject path, counters and pull gauges
as every other workload (greptime_memory_* metrics, /status usage).  The
over-quota error surface is deliberate and distinct per cause:

    rate        -> RateLimited            (StatusCode.RATE_LIMITED, HTTP 429)
    concurrency -> RateLimited            (back off and retry is correct)
    memory      -> ResourcesExhausted     (RUNTIME_RESOURCES_EXHAUSTED, 503)

Rate limiting is a token bucket per tenant (qps refill, burst capacity),
checked lock-free-ish under one small lock at submit time.  ``try_admit``
mirrors memory.py's reject-to-fallback probe for callers that prefer to
degrade (e.g. demote to background priority) over failing the query.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from greptimedb_tpu_torch.errors import RateLimited, ResourcesExhausted
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

M_REJECTED = REGISTRY.counter(
    "greptime_scheduler_rejected_total",
    "queries rejected at admission", labels=("tenant", "reason"))
M_ADMITTED = REGISTRY.counter(
    "greptime_scheduler_admitted_total",
    "queries admitted into the scheduler", labels=("tenant",))
M_INFLIGHT = REGISTRY.gauge(
    "greptime_scheduler_tenant_inflight",
    "admitted-but-not-finished queries per tenant", labels=("tenant",))


@dataclass
class TenantQuota:
    """Per-tenant budgets; None means unlimited (the default tenant ships
    unlimited unless GREPTIME_TENANT_* env defaults say otherwise)."""

    qps: float | None = None
    burst: float | None = None  # bucket capacity; defaults to max(qps, 1)
    mem_bytes: int | None = None
    max_inflight: int | None = None


class _TenantState:
    __slots__ = ("quota", "tokens", "last_refill", "inflight",
                 "reserved_bytes")

    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.tokens = float(quota.burst or max(quota.qps or 1.0, 1.0))
        self.last_refill = time.monotonic()
        self.inflight = 0
        self.reserved_bytes = 0


class TenantAdmission:
    """Admission gate the scheduler consults at submit time.  ``memory``
    is the db's WorkloadMemoryManager; per-tenant memory budgets register
    there as ``tenant:<name>`` workloads (usage_fn pulls the tenant's
    live reserved bytes — one source of truth, like every workload)."""

    def __init__(self, memory=None, defaults: TenantQuota | None = None):
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        self.memory = memory
        self.defaults = defaults or TenantQuota()

    # ------------------------------------------------------------------
    def set_quota(self, tenant: str, *, qps: float | None = None,
                  burst: float | None = None, mem_bytes: int | None = None,
                  max_inflight: int | None = None) -> None:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._new_state(tenant, TenantQuota(
                    qps=qps, burst=burst, mem_bytes=mem_bytes,
                    max_inflight=max_inflight))
                self._tenants[tenant] = st
            else:
                st.quota = TenantQuota(qps=qps, burst=burst,
                                       mem_bytes=mem_bytes,
                                       max_inflight=max_inflight)
                st.tokens = min(
                    st.tokens,
                    float(burst or max(qps or 1.0, 1.0)))
        if self.memory is not None:
            self.memory.set_quota(f"tenant:{tenant}", mem_bytes)

    def _new_state(self, tenant: str, quota: TenantQuota) -> _TenantState:
        st = _TenantState(quota)
        # pull gauge: newest tenant state of this name wins (same
        # last-registration-wins rule as memory.py's workload gauges)
        M_INFLIGHT.labels(tenant).set_function(
            lambda s=st: float(s.inflight))
        if self.memory is not None:
            # pull-based usage (memory.py discipline): the gauge and the
            # admit check both read the tenant's live reservation
            self.memory.register(
                f"tenant:{tenant}", quota.mem_bytes,
                usage_fn=lambda s=st: s.reserved_bytes,
                policy="reject",
            )
        return st

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._new_state(tenant, TenantQuota(
                qps=self.defaults.qps, burst=self.defaults.burst,
                mem_bytes=self.defaults.mem_bytes,
                max_inflight=self.defaults.max_inflight))
            self._tenants[tenant] = st
        return st

    # ------------------------------------------------------------------
    def admit(self, tenant: str, est_bytes: int = 0) -> None:
        """Admit one query or raise; pair every successful call with
        ``release`` (the scheduler does this in a finally).  Checks AND
        the inflight/reserved increments happen under one lock hold, so
        concurrent submits cannot race past a quota (the shared memory
        manager takes only its own lock and our usage_fn is lock-free, so
        nesting the memory.admit call here cannot deadlock)."""
        with self._lock:
            st = self._state(tenant)
            q = st.quota
            if q.qps is not None:
                now = time.monotonic()
                cap = float(q.burst or max(q.qps, 1.0))
                st.tokens = min(cap, st.tokens + (now - st.last_refill) * q.qps)
                st.last_refill = now
                if st.tokens < 1.0:
                    M_REJECTED.labels(tenant, "rate").inc()
                    raise RateLimited(
                        f"tenant {tenant!r} over rate quota "
                        f"({q.qps:g} qps)")
                st.tokens -= 1.0
            if q.max_inflight is not None and st.inflight >= q.max_inflight:
                M_REJECTED.labels(tenant, "concurrency").inc()
                raise RateLimited(
                    f"tenant {tenant!r} over concurrency quota "
                    f"({st.inflight} >= {q.max_inflight} in flight)")
            if q.mem_bytes is not None and self.memory is not None:
                try:
                    # the shared manager applies the reject policy + counters
                    self.memory.admit(f"tenant:{tenant}", est_bytes)
                except ResourcesExhausted:
                    M_REJECTED.labels(tenant, "memory").inc()
                    raise ResourcesExhausted(
                        f"tenant {tenant!r} over memory quota: {est_bytes} "
                        f"bytes requested, {st.reserved_bytes} reserved of "
                        f"{q.mem_bytes}") from None
            st.inflight += 1
            st.reserved_bytes += est_bytes
        M_ADMITTED.labels(tenant).inc()

    def try_admit(self, tenant: str, est_bytes: int = 0) -> bool:
        """Non-raising probe (memory.py reject-to-fallback twin): callers
        degrade — e.g. demote the query to background — instead of
        surfacing the rejection."""
        try:
            self.admit(tenant, est_bytes)
        except (RateLimited, ResourcesExhausted):
            return False
        return True

    def release(self, tenant: str, est_bytes: int = 0) -> None:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return
            st.inflight = max(0, st.inflight - 1)
            st.reserved_bytes = max(0, st.reserved_bytes - est_bytes)

    # ------------------------------------------------------------------
    def usage(self) -> dict[str, dict]:
        with self._lock:
            return {
                t: {
                    "inflight": st.inflight,
                    "reserved_bytes": st.reserved_bytes,
                    "qps": st.quota.qps,
                    "mem_bytes": st.quota.mem_bytes,
                    "max_inflight": st.quota.max_inflight,
                }
                for t, st in self._tenants.items()
            }
