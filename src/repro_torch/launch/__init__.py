"""Launchers of the PyTorch port (counterpart of ``repro.launch``)."""
