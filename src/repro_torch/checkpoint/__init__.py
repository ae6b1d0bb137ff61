"""Durability of the PyTorch port (counterpart of ``repro.checkpoint``)."""
