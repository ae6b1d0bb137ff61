"""Core search library of the PyTorch port (counterpart of ``repro.core``)."""
