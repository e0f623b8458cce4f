"""Metrics registry: counters/gauges/histograms + Prometheus text export.

Equivalent of the reference's per-crate lazy_static metric registries
exported at /metrics (SURVEY.md §5.5, src/servers/src/http.rs:944).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class _Metric:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _new_child(self):
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    class _Child:
        __slots__ = ("value", "_mu")

        def __init__(self):
            self.value = 0.0
            # float += is a read-modify-write (LOAD/ADD/STORE bytecodes):
            # concurrent inc() from the scheduler workers and the ingest
            # pool interleaves and LOSES updates without this — counter
            # drift that survives until restart.  Scrape-time reads stay
            # lock-free (a torn read of one float is impossible).
            self._mu = threading.Lock()

        def inc(self, by: float = 1.0):
            with self._mu:
                self.value += by

    def _new_child(self):
        return Counter._Child()

    def inc(self, by: float = 1.0):
        self.labels().inc(by)


class Gauge(_Metric):
    kind = "gauge"

    class _Child:
        __slots__ = ("_value", "fn", "_mu")

        def __init__(self):
            self._value = 0.0
            self.fn = None
            self._mu = threading.Lock()  # see Counter._Child

        @property
        def value(self):
            # pull-mode gauge (set_function): evaluated at scrape time so
            # /metrics and runtime_metrics read live state with exactly one
            # source of truth (the owning component); a dead or raising
            # callback degrades to 0.0 rather than failing the scrape
            if self.fn is not None:
                try:
                    return float(self.fn())
                except Exception:  # noqa: BLE001
                    return 0.0
            return self._value

        def set(self, v: float):
            with self._mu:
                self._value = v

        def inc(self, by: float = 1.0):
            with self._mu:
                self._value += by

        def dec(self, by: float = 1.0):
            with self._mu:
                self._value -= by

        def set_function(self, fn):
            self.fn = fn

    def _new_child(self):
        return Gauge._Child()

    def set(self, v: float):
        self.labels().set(v)

    def set_function(self, fn):
        self.labels().set_function(fn)


_DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labels, buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.buckets = tuple(sorted(buckets))

    class _Child:
        __slots__ = ("counts", "total", "sum", "buckets", "_mu")

        def __init__(self, buckets):
            self.buckets = buckets
            self.counts = [0] * len(buckets)
            self.total = 0
            self.sum = 0.0
            self._mu = threading.Lock()  # see Counter._Child

        def observe(self, v: float):
            with self._mu:
                self.total += 1
                self.sum += v
                for i, b in enumerate(self.buckets):
                    if v <= b:
                        self.counts[i] += 1

        def time(self):
            return _Timer(self)

    def _new_child(self):
        return Histogram._Child(self.buckets)

    def observe(self, v: float):
        self.labels().observe(v)

    def time(self):
        return self.labels().time()


class _Timer:
    def __init__(self, child):
        self.child = child

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.child.observe(time.perf_counter() - self.t0)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        # conflicting re-registrations (same name, different kind or label
        # set).  Registration never raises — a metric collision must not
        # kill a server at import time — but the tier-1 registry check
        # (tests/test_telemetry.py) fails the build on any entry here.
        self.collisions: list[str] = []

    def counter(self, name, help_="", labels=()):
        return self._get(Counter, name, help_, tuple(labels))

    def gauge(self, name, help_="", labels=()):
        return self._get(Gauge, name, help_, tuple(labels))

    def histogram(self, name, help_="", labels=(), buckets=_DEFAULT_BUCKETS):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help_, tuple(labels), buckets)
                self._metrics[name] = m
            else:
                self._note_collision(m, Histogram, name, tuple(labels))
            return m

    def _get(self, cls, name, help_, labels):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, labels)
                self._metrics[name] = m
            else:
                self._note_collision(m, cls, name, labels)
            return m

    def _note_collision(self, existing, cls, name, labels):  # gl: holds[_lock]
        if type(existing) is not cls:
            self.collisions.append(
                f"{name}: registered as {existing.kind}, "
                f"re-registered as {cls.kind}")
        elif existing.label_names != labels:
            self.collisions.append(
                f"{name}: labels {existing.label_names} vs {labels}")

    def value(self, name: str, labels: tuple = ()) -> float:
        """Read one child's current value (counter/gauge) or observation
        count (histogram) without reaching into component objects — the
        one bench-facing read path, so bench JSON and /metrics can
        never disagree.  Missing metric or label combination reads 0.0."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            return 0.0
        key = tuple(str(v) for v in labels)
        child = m._children.get(key)
        if child is None:
            return 0.0
        if m.kind == "histogram":
            return float(child.total)
        return float(child.value)

    def snapshot(self):
        """Consistent point-in-time view: (metric_name, kind, label_names,
        label_values, child) rows, taken under the proper locks. The one
        supported way to walk the registry from outside (information_schema)."""
        with self._lock:
            metrics = list(self._metrics.values())
        rows = []
        for m in metrics:
            with m._lock:  # labels() may insert children concurrently
                children = sorted(m._children.items())
            for key, child in children:
                rows.append((m.name, m.kind, m.label_names, key, child))
        return rows

    def export_samples(self) -> list[tuple[str, dict, float]]:
        """Flat (table_name, labels, value) samples for the metrics
        self-import loop (reference ``export_metrics`` self_import,
        src/common/telemetry): counters and gauges sample as themselves;
        histograms explode prometheus-style into ``<name>_bucket``
        (cumulative counts with an ``le`` label), ``<name>_sum`` and
        ``<name>_count`` — the SAME shape servers/otlp.py produces for
        OTLP histogram ingest, so ``histogram_quantile`` works over
        self-imported tables unchanged.  Pull gauges (set_function)
        evaluate at sample time, like a scrape."""
        out: list[tuple[str, dict, float]] = []
        for name, kind, label_names, key, child in self.snapshot():
            labels = dict(zip(label_names, key))
            if kind == "histogram":
                for b, c in zip(child.buckets, child.counts):
                    out.append((name + "_bucket",
                                {**labels, "le": str(b)}, float(c)))
                out.append((name + "_bucket",
                            {**labels, "le": "+Inf"}, float(child.total)))
                out.append((name + "_sum", labels, float(child.sum)))
                out.append((name + "_count", labels, float(child.total)))
            else:
                out.append((name, labels, float(child.value)))
        return out

    def render(self) -> str:
        """Prometheus text exposition format.  Children are copied under
        each metric's lock (same discipline as snapshot()): a scrape on
        the server thread races label() inserts from executor threads —
        every query/flow/protocol can mint a new label child."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out = []
        for m in metrics:
            name = m.name
            out.append(f"# HELP {name} {_escape_help(m.help)}")
            out.append(f"# TYPE {name} {m.kind}")
            with m._lock:
                children = sorted(m._children.items())
            for key, child in children:
                lab = ",".join(
                    f'{n}="{_escape_label(v)}"'
                    for n, v in zip(m.label_names, key)
                )
                lab = "{" + lab + "}" if lab else ""
                if m.kind == "histogram":
                    # child.counts is already cumulative (observe()
                    # increments every bucket >= v)
                    for b, c in zip(m.buckets, child.counts):
                        blab = (lab[:-1] + "," if lab else "{") + f'le="{b}"' + "}"
                        out.append(f"{name}_bucket{blab} {c}")
                    inf_lab = (lab[:-1] + "," if lab else "{") + 'le="+Inf"' + "}"
                    out.append(f"{name}_bucket{inf_lab} {child.total}")
                    out.append(f"{name}_sum{lab} {child.sum}")
                    out.append(f"{name}_count{lab} {child.total}")
                else:
                    out.append(f"{name}{lab} {child.value}")
        return "\n".join(out) + "\n"


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline (exposition format spec §label values)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


REGISTRY = Registry()

# ---------------------------------------------------------------------------
# Instance-identity metrics (reference src/common/telemetry build info +
# process collector): registered once at import so every surface that walks
# the registry (/metrics, information_schema.runtime_metrics) carries them.
# ---------------------------------------------------------------------------

_PROCESS_START_S = time.time()


def _register_process_metrics() -> None:
    try:
        from greptimedb_tpu_torch import __version__ as _version
    except Exception:  # noqa: BLE001 — partial import during bootstrap
        _version = "unknown"
    build = REGISTRY.gauge(
        "greptime_build_info",
        "Instance identity; value is constant 1",
        labels=("version", "backend"),
    )
    import os as _os

    build.labels(_version, _os.environ.get("JAX_PLATFORMS") or "auto").set(1)
    start = REGISTRY.gauge(
        "greptime_process_start_time_seconds",
        "Unix time the process started",
    )
    start.set(_PROCESS_START_S)
    uptime = REGISTRY.gauge(
        "greptime_process_uptime_seconds",
        "Seconds since process start",
    )
    uptime.set_function(lambda: time.time() - _PROCESS_START_S)


_register_process_metrics()
