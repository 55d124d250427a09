"""PyTorch / CUDA port of the SparkAttention reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout and module names so each counterpart sits at the same
path. It imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro`` (``tests/test_torch_boundary.py`` enforces it). The Pallas TPU
kernels on the ported paths are hand-written CUDA kernels for Hopper
(``kernels/csrc/``); every kernel wrapper runs its plain-torch version on a
CPU tensor and launches the kernel on a CUDA tensor.
"""
