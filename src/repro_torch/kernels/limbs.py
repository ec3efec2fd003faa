"""Limb decompositions of ring words, and the launch plan of the limb
tensor-core kernels.

Port of ``repro/kernels/limbs.py::balanced_limbs``, bit-exact including the
carry boundary (32767 -> [-1, -128, 1, 0]).  The balanced limbs fill the
weight caches (``WeightLimbs`` / ``GroupedWeightLimbs`` and the public
``PublicWeightLimbs`` / ``PublicGroupedLimbs``) and give the public
weights' adaptive limb count.

The B1 and B3 CUDA kernels (``csrc/limb_mma.cuh``) multiply on the int8
tensor cores: the four bytes of an activation word are its *unsigned*
limbs, x ≡ Σ_p u_p·2^{8p} (mod 2^32), and the cached weight limbs are the
balanced signed ones, w ≡ Σ_q v_q·2^{8q}.  Products with p + q ≥ 4 are
multiples of 2^32, so

    x·w ≡ Σ_{s<4} 2^{8s} · Σ_{p+q=s} u_p·v_q        (mod 2^32)

with one int32 accumulator per shift s (its wrap is harmless: only its
value mod 2^{32-8s} reaches the result).  :func:`limb_mma_plan` is the
launch plan the wrappers hand those kernels.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["N_LIMBS", "balanced_limbs", "limb_mma_plan", "sm_count",
           "TENSOR_CORE", "CUDA_CORE", "K_STAGE"]

N_LIMBS = 4

TENSOR_CORE, CUDA_CORE = "tensor-core", "cuda-core"
# the tensor-core kernel (csrc/limb_mma.cuh): output tile, K stage depth,
# blocks an SM
_BM, _BN, K_STAGE, _BLOCKS_PER_SM = 64, 64, 32, 2
# at K <= this the CUDA cores are faster: a k32 tensor-core step would be
# half padding or more
_TINY_K = 16
# a block's cost beyond its K stages, in stages: the cp.async ring's fill
# and the epilogue, and the more of a split block's atomic epilogue
_BLOCK_OVERHEAD, _ATOMIC_OVERHEAD = 2, 2


def balanced_limbs(x: torch.Tensor) -> torch.Tensor:
    """int32 ring words (...) -> int8 (4, ...) with
    x ≡ Σ limb_p · 2^{8p} (mod 2^32), every limb in [-128, 127]."""
    limbs = []
    cur = x.to(torch.int32)
    for _ in range(N_LIMBS):
        lo = cur & 0xFF
        carry = (lo >= 128).to(torch.int32)
        limbs.append((lo - 256 * carry).to(torch.int8))
        cur = ((cur >> 8) & 0xFFFFFF) + carry   # logical shift
    return torch.stack(limbs)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def limb_mma_plan(s: int, m: int, k: int, n: int, sms: int
                  ) -> tuple[str, int, int]:
    """(route, K stages per split, splits) of B1's or B3's kernel at an
    (S, M, K) x (K, N) shape on a card with ``sms`` SMs.

    K <= 16 takes the CUDA-core route (one split).  Otherwise the
    tensor-core kernel runs one block per (slot, 64-row, 64-col) tile and
    range of 32-deep K stages.  The split count takes the least waves of
    blocks times the cost of a block (its stages and a fixed overhead,
    more for the atomic epilogue of a split), so the M = 32 layers (a few
    tiles) split K until the card is full, and a long grid just past one
    wave splits to even the waves out; ties go to fewer splits."""
    steps = -(-k // K_STAGE)
    if k <= _TINY_K:
        return CUDA_CORE, steps, 1
    tiles = s * -(-m // _BM) * -(-n // _BN)
    slots = sms * _BLOCKS_PER_SM

    def cost(splits):
        per = -(-steps // splits)
        used = -(-steps // per)
        waves = -(-tiles * used // slots)
        extra = _BLOCK_OVERHEAD + (_ATOMIC_OVERHEAD if used > 1 else 0)
        return waves * (per + extra), used

    per = -(-steps // min(range(1, steps + 1), key=cost))
    return TENSOR_CORE, per, -(-steps // per)
