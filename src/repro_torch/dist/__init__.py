"""Step builders of the PyTorch port (counterpart of ``repro.dist``)."""
