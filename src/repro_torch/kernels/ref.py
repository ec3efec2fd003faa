"""The plain versions of the kernels, under the reference's module name.

Port of ``repro/kernels/ref.py``: its four oracles are the port's plain
versions, which live beside their kernels (each wrapper takes them on a
CPU tensor, and tests and ``chip_smoke.py`` hold the kernels to them).
"""
from __future__ import annotations

from .binary_matmul import binary_binary_matmul_ref, binary_weight_matmul_ref
from .flash_attention import flash_attention_ref
from .ring_matmul import ring_matmul_ref

__all__ = ["ring_matmul_ref", "binary_weight_matmul_ref",
           "binary_binary_matmul_ref", "flash_attention_ref"]
