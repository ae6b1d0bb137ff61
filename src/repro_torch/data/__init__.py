"""Deterministic synthetic data (port of ``repro.data``)."""
