"""Serving runtime of the PyTorch port (counterpart of ``repro.runtime``)."""
