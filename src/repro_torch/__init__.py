"""PyTorch/CUDA port of the CBNN secure-inference system.

Held against the JAX package ``repro`` (the reference): same layout, same
function names, and bit-identical shares, ledgers and opened logits for the
same seeds.  Ring elements are stored as ``torch.int32`` (two's-complement
wrap is arithmetic mod 2^32); the linear-layer kernels (shared- and
public-weight) are CUDA C++ for Hopper (``csrc/``), built with nvcc at
first use.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
