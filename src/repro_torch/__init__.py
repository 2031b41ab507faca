"""PyTorch port of the durable-set reproduction, for NVIDIA Hopper GPUs.

Mirrors the layout of the JAX package ``repro``, which stays the reference:
``repro_torch.core`` (stage machine, op bodies, engine, state conversion),
``repro_torch.kernels`` (hand-written CUDA kernels with their plain
PyTorch versions) and ``repro_torch.obs``.  Imports torch, numpy and the
standard library only.
"""
