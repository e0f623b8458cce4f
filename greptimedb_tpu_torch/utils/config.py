"""Layered configuration: defaults → TOML file → env vars → CLI flags.

Reference: the Configurable trait over the config crate (SURVEY.md §5.6,
src/common/config/): env vars use the GREPTIMEDB_<ROLE>__SECTION__KEY
convention with ``__`` as the section separator; later layers win.
"""

from __future__ import annotations

import os
import re

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is API-compatible
    import tomli as tomllib
from dataclasses import dataclass, field, fields, is_dataclass


@dataclass
class HttpOptions:
    addr: str = "127.0.0.1:4000"
    timeout_s: float = 30.0
    body_limit_mb: int = 64
    # [http.tls] (reference config/standalone.example.toml:14-27)
    tls_mode: str = "disable"  # disable | require | self_signed
    tls_cert_path: str = ""
    tls_key_path: str = ""


@dataclass
class WalOptions:
    provider: str = "file"  # file | noop
    sync: bool = False


@dataclass
class StorageOptions:
    data_home: str = "./greptimedb_data"
    flush_threshold_mb: int = 256
    compaction_window_hours: int = 24
    compaction_trigger_files: int = 8
    cache_capacity_gb: int = 8


@dataclass
class MemoryOptions:
    """Workload quotas (reference common-memory-manager). 0 = unlimited."""

    ingest_quota_mb: int = 0
    ingest_policy: str = "reject"  # reject | best_effort


@dataclass
class DeviceOptions:
    platform: str = ""  # "" = jax default; "cpu" forces host
    mesh_shards: int = 0  # 0 = all available devices


@dataclass
class MysqlOptions:
    enable: bool = True
    addr: str = "127.0.0.1:4002"
    tls_mode: str = "disable"
    tls_cert_path: str = ""
    tls_key_path: str = ""


@dataclass
class PostgresOptions:
    enable: bool = True
    addr: str = "127.0.0.1:4003"
    tls_mode: str = "disable"
    tls_cert_path: str = ""
    tls_key_path: str = ""
    auth_mode: str = "scram"  # scram | cleartext (with a user provider)


@dataclass
class AuthOptions:
    # "user:password" entries; empty = open access
    users: list = field(default_factory=list)


@dataclass
class SlowQueryOptions:
    threshold_ms: float = 0.0  # 0 disables recording


@dataclass
class StandaloneOptions:
    node_id: int = 0
    default_timezone: str = "UTC"
    auth: AuthOptions = field(default_factory=AuthOptions)
    slow_query: SlowQueryOptions = field(default_factory=SlowQueryOptions)
    http: HttpOptions = field(default_factory=HttpOptions)
    mysql: MysqlOptions = field(default_factory=MysqlOptions)
    postgres: PostgresOptions = field(default_factory=PostgresOptions)
    wal: WalOptions = field(default_factory=WalOptions)
    storage: StorageOptions = field(default_factory=StorageOptions)
    memory: MemoryOptions = field(default_factory=MemoryOptions)
    device: DeviceOptions = field(default_factory=DeviceOptions)


def _apply_dict(obj, data: dict) -> None:
    for f in fields(obj):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(obj, f.name)
        if is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v)
        else:
            setattr(obj, f.name, type(cur)(v) if cur is not None else v)


def _apply_env(obj, prefix: str) -> None:
    for f in fields(obj):
        cur = getattr(obj, f.name)
        key = f"{prefix}__{f.name.upper()}"
        if is_dataclass(cur):
            _apply_env(cur, key)
        elif key in os.environ:
            raw = os.environ[key]
            if isinstance(cur, bool):
                setattr(obj, f.name, raw.lower() in ("1", "true", "yes", "on"))
            elif isinstance(cur, list):
                # comma-separated entries; list(str) would explode into chars
                setattr(obj, f.name,
                        [p.strip() for p in raw.split(",") if p.strip()])
            else:
                setattr(obj, f.name, type(cur)(raw))


def load_options(
    config_file: str | None = None,
    env_prefix: str = "GREPTIMEDB_STANDALONE",
    overrides: dict | None = None,
) -> StandaloneOptions:
    opts = StandaloneOptions()
    if config_file:
        with open(config_file, "rb") as f:
            _apply_dict(opts, tomllib.load(f))
    _apply_env(opts, env_prefix)
    if overrides:
        _apply_dict(opts, overrides)
    return opts


def to_dict(obj) -> dict:
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = to_dict(v) if is_dataclass(v) else v
    return out


_DUR_RE = re.compile(r"(\d+)\s*(us|ms|s|m|h|d|w|y)")


def parse_duration_ms(text: str) -> int | None:
    """Humantime-style duration -> milliseconds (reference accepts e.g.
    ttl='7d', '1h 30m'; src/store-api/src/mito_engine_options.rs).
    'forever'/''/'0' -> None (keep forever)."""
    s = str(text).strip().lower()
    if s in ("", "forever", "0"):
        return None
    zero_ok = False
    units = {"us": 0.001, "ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000,
             "d": 86_400_000, "w": 7 * 86_400_000, "y": 365 * 86_400_000}
    pos = 0
    total = 0.0
    for m in _DUR_RE.finditer(s):
        if s[pos:m.start()].strip():
            raise ValueError(f"invalid duration {text!r}")
        total += int(m.group(1)) * units[m.group(2)]
        pos = m.end()
        zero_ok = True
    if pos != len(s.rstrip()) or not zero_ok:
        raise ValueError(f"invalid duration {text!r}")
    if total == 0:
        return None  # '0s' == forever, same as '0' (humantime semantics)
    return max(int(total), 1)  # sub-ms ttl rounds up, never to 'forever'
