"""Telemetry configuration (the port of `repro.obs.config`)."""
