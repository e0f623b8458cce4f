"""Shared runtime utilities: telemetry, config, codecs."""
