"""Attention kernels: CUDA kernels for Hopper, their plain-torch versions,
the naive oracle and the public ops surface."""
