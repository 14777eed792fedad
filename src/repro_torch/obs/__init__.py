"""Telemetry taps (the tiered counters view)."""
