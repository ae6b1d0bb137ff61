"""PyTorch/CUDA port of the ``repro`` similarity-search package.

The JAX package ``repro`` is the reference; this package mirrors its module
paths and public names (``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``) and is held bit-for-bit against it on integer
outputs. It never imports ``jax`` or ``repro``.

Entry points that create tensors run on CUDA unless the caller passes
``device="cpu"``; with no device given and no CUDA device present they raise
(``repro_torch.device.resolve``). Functions that take tensors run on the
tensors' device. The two-pass counting-select kernels (K1 pass-1 histogram,
K2 pass-2 emit) are hand-written CUDA for ``sm_90a``
(``kernels/csrc/topk_select.cu``); on CPU tensors their wrappers run the
plain PyTorch versions.
"""
