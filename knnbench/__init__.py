"""The benchmark of the PyTorch/CUDA port (``repro_torch``): exact Hamming
kNN through ``KNNEngine.search``. ``python3 knnbench/run.py --help``."""
