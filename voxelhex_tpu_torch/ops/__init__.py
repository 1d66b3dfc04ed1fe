"""Hand-written CUDA kernels and their wrappers.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
kernel's plain PyTorch version for CPU tensors, and counts its launches in
``<wrapper>.launches``.
"""
