"""Models of the PyTorch port (counterpart of ``repro.models``)."""
