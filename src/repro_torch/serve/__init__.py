"""Serving: the engine, its scheduler and the tiered-store helpers."""
