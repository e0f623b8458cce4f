"""Deterministic fault injection for the cluster serving stack.

Reference analog: tests-fuzz/ (failover/unstable targets) plus the
error-injection layers greptimedb gets for free from its object-store
stack — here a single in-process controller every remote boundary
consults before doing real work.  The point is that faults are
*survived, not just observed*: the same PR wires retry/timeout/backoff
into rpc/client.py and storage/s3.py, and the chaos test tier asserts
end-to-end invariants (zero acked-write loss, correct query results,
bounded staleness) while this layer fires.

Design constraints:

- **Zero overhead disabled.**  ``CHAOS.inject(point)`` is one attribute
  check when no rules are configured (the production default) — the
  same discipline as utils/tracing.py.  The warm query path must not
  pay for the failure machinery it never uses.
- **Deterministic.**  Every injection point owns a seeded RNG stream
  (seed ⊕ stable hash of the point name), so a seeded run fires the
  same faults at the same call indices every time — tests assert exact
  recovery behavior, not probabilistic soup.
- **Env-propagated.**  ``GREPTIME_CHAOS`` configures the controller at
  import (``seed=7;flight.call=0.2:error;wal.append=0.1:stall:50``), so
  datanode OS subprocesses inherit the faults of the test that spawned
  them.

Injection points:

=======================  ===================================== ==========
point                    site                                  actions
=======================  ===================================== ==========
``flight.call``          every DatanodeClient RPC (rpc/client) error/delay/drop
``datanode.call``        Flight server do_put/do_get/do_action error/hang/kill
``s3.read``              S3ObjectStore GET (storage/s3)        error/delay
``s3.read.payload``      S3ObjectStore GET response bytes      bitflip
``wal.append``           SharedLogBroker.append (remote_wal)   stall/error
``fs.write``             FsObjectStore.write payload           torn/bitflip/error/kill
``fs.fsync``             FsObjectStore.write fsync/dir-fsync   error/kill/delay
``wal.flush``            FileLogStore._flush_records           torn/bitflip/error/kill
``sst.read``             read_sst file bytes (storage/sst)     bitflip/error/delay
``sst.write``            write_sst store write (storage/sst)   torn/bitflip/error/kill
``manifest.delta``       Manifest.commit delta write           bitflip/error/kill
``manifest.checkpoint``  Manifest.checkpoint write             bitflip/error/kill
``manifest.gc``          Manifest checkpoint GC delete loop    error/kill
``s3.cas``               S3 write_if between CAS + cache fill  error/kill
``scrub.read``           Scrubber per-item verify (scrubber)   error/kill/delay
``broker.replica``       SharedLogBroker per-replica append    error/kill/stall
=======================  ===================================== ==========

Local-disk fault shapes: ``torn`` persists a PREFIX of the
payload then fails (crash mid-write); ``bitflip`` corrupts one byte of
the payload and lets the IO "succeed" (silent bit-rot — the read path
must detect it); ``at=N`` makes a rule fire deterministically at the
Nth call of its point regardless of probability (the crash-at-Nth-
boundary matrix), e.g. ``GREPTIME_CHAOS=manifest.delta=1:kill:at=3``.

Data-carrying points go through ``filter_io(point, data)``; call sites
guard it with the same ``CHAOS.enabled`` one-attribute check, so the
disabled production path never pays for the mutation machinery.
"""

from __future__ import annotations

import os
import random
import threading
import time
import zlib
from dataclasses import dataclass

from greptimedb_tpu_torch.errors import GreptimeError
from greptimedb_tpu_torch.utils.telemetry import REGISTRY

# Shared fault-pressure counter: every survived retry at a remote
# boundary (Flight RPC, S3 request) increments it, so /metrics shows
# injected-or-real fault pressure in one place.
M_REMOTE_RETRY = REGISTRY.counter(
    "greptime_remote_retry_total",
    "Retries against remote services (flight RPC, object store)",
    labels=("service", "kind"),
)

M_CHAOS_INJECTED = REGISTRY.counter(
    "greptime_chaos_injected_total",
    "Faults fired by the chaos controller",
    labels=("point", "action"),
)


class ChaosError(GreptimeError):
    """An injected fault.  Retry layers treat it as transient (it models
    a dropped/failed remote call), so a survivable fault is survived."""


@dataclass
class ChaosRule:
    point: str
    prob: float
    action: str = "error"  # error|delay|stall|drop|hang|kill|torn|bitflip
    delay_ms: float = 20.0
    limit: int | None = None  # max fires; None = unbounded
    fired: int = 0
    # deterministic crash-at-Nth-boundary: fire exactly at the Nth call
    # of this point (1-based), ignoring prob — the recovery matrix seeds
    # a kill at every durability boundary index this way
    at: int | None = None
    calls: int = 0


def _parse_rules(spec: str) -> tuple[int, dict[str, ChaosRule]]:
    """``seed=7;flight.call=0.2:error;wal.append=0.1:stall:50;s3.read=1:error:limit=2``

    Each rule is ``point=prob[:action[:delay_ms_or_limit]...]``; a bare
    ``limit=N`` arg caps total fires for the rule and ``at=N`` pins the
    rule to fire exactly at the point's Nth call.
    """
    seed = 0
    rules: dict[str, ChaosRule] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key = key.strip()
        if key == "seed":
            seed = int(val)
            continue
        args = val.split(":")
        rule = ChaosRule(point=key, prob=float(args[0]))
        for a in args[1:]:
            if a.startswith("limit="):
                rule.limit = int(a[len("limit="):])
            elif a.startswith("at="):
                rule.at = int(a[len("at="):])
            elif a.replace(".", "", 1).isdigit():
                rule.delay_ms = float(a)
            elif a:
                rule.action = a
        rules[key] = rule
    return seed, rules


class ChaosController:
    """Seed-driven fault firing at named injection points."""

    def __init__(self) -> None:
        self.enabled = False
        self.seed = 0
        self._rules: dict[str, ChaosRule] = {}
        self._rngs: dict[str, random.Random] = {}
        self._lock = threading.Lock()

    # ---- configuration -------------------------------------------------
    @classmethod
    def from_env(cls) -> "ChaosController":
        c = cls()
        spec = os.environ.get("GREPTIME_CHAOS", "")
        if spec:
            seed, rules = _parse_rules(spec)
            c.configure(seed, rules)
        return c

    def configure(self, seed: int,
                  rules: dict[str, ChaosRule] | None) -> None:
        with self._lock:
            self.seed = seed
            self._rules = dict(rules or {})
            self._rngs = {}
            self.enabled = bool(self._rules)

    def rule(self, point: str, prob: float, action: str = "error",
             delay_ms: float = 20.0, limit: int | None = None,
             at: int | None = None) -> None:
        """Programmatic single-rule setup (tests)."""
        with self._lock:
            self._rules[point] = ChaosRule(point, prob, action, delay_ms,
                                           limit, at=at)
            self._rngs.pop(point, None)
            self.enabled = True

    def reset(self) -> None:
        self.configure(0, None)

    def fired(self, point: str) -> int:
        r = self._rules.get(point)
        return r.fired if r is not None else 0

    # ---- firing --------------------------------------------------------
    def _rng(self, point: str) -> random.Random:
        rng = self._rngs.get(point)
        if rng is None:
            # stable per-point stream: the same seeded run fires the same
            # faults at the same call indices regardless of rule order
            rng = random.Random(self.seed ^ zlib.crc32(point.encode()))
            self._rngs[point] = rng
        return rng

    def _fire(self, point: str) -> tuple[str, float] | None:
        """Decide under the lock whether ``point``'s rule fires at this
        call; returns (action, delay_s) or None."""
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return None
            rule.calls += 1
            if rule.limit is not None and rule.fired >= rule.limit:
                return None
            if rule.at is not None:
                if rule.calls != rule.at:
                    return None
            elif self._rng(point).random() >= rule.prob:
                return None
            rule.fired += 1
            action = rule.action
            delay_s = rule.delay_ms / 1000.0
        M_CHAOS_INJECTED.labels(point, action).inc()
        return action, delay_s

    def inject(self, point: str) -> None:
        """Fire the configured fault for ``point`` (or return untouched).

        error/drop → raise ChaosError; delay/stall → sleep ``delay_ms``;
        hang → sleep 1000×``delay_ms`` (the caller's deadline must save
        it); kill → hard process exit (SIGKILL analog for chaos tests).
        torn/bitflip are data faults: at a non-data point they degrade to
        error (a rule misconfiguration must still be loud, not silent).
        """
        if not self.enabled:  # production fast path: one attribute check
            return
        fired = self._fire(point)
        if fired is None:
            return
        action, delay_s = fired
        if action in ("delay", "stall"):
            time.sleep(delay_s)
            return
        if action == "hang":
            time.sleep(delay_s * 1000.0)
            return
        if action == "kill":
            os._exit(137)
        raise ChaosError(f"chaos[{point}]: injected {action}")

    def filter_io(self, point: str,
                  data: bytes) -> tuple[bytes, Exception | None]:
        """Data-carrying injection for local-disk IO: returns
        ``(data_to_use, error_to_raise_after_io)``.

        - ``torn``: a strict PREFIX of the payload plus a ChaosError the
          caller must raise AFTER persisting the prefix — a torn write;
        - ``bitflip``: the payload with one byte corrupted and no error —
          silent bit-rot the verifying read path must catch;
        - ``error``/``drop``: raises immediately (IO never happens);
        - ``delay``/``stall``: sleeps, data untouched;
        - ``kill``: hard process exit at the IO boundary.

        Call sites guard with ``if CHAOS.enabled:`` so the disabled path
        stays one attribute check (the zero-overhead pin).
        """
        if not self.enabled:
            return data, None
        fired = self._fire(point)
        if fired is None:
            return data, None
        action, delay_s = fired
        if action in ("delay", "stall"):
            time.sleep(delay_s)
            return data, None
        if action == "kill":
            os._exit(137)
        if action == "bitflip":
            if not data:
                return data, None
            pos = self._rng(point).randrange(len(data))
            mutated = bytearray(data)
            mutated[pos] ^= 1 << self._rng(point).randrange(8)
            return bytes(mutated), None
        if action == "torn":
            cut = self._rng(point).randrange(len(data)) if data else 0
            return data[:cut], ChaosError(
                f"chaos[{point}]: torn write after {cut}/{len(data)} bytes")
        raise ChaosError(f"chaos[{point}]: injected {action}")


CHAOS = ChaosController.from_env()
