"""Hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version (``ref.py``) and a wrapper that counts its launches (``kernel.py``)."""
