"""Metadata: kv backend, catalog, procedures and DDL (host code, copied
from the reference)."""
