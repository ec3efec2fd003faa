"""Launch choices of the dense limb kernels, the unit the autotuner searches.

Counterpart of ``repro/kernels/lowering.py::KernelConfig``.  The reference
searches Pallas block sizes and a Pallas-or-XLA lowering; the port's CUDA
kernels (B1 ``csrc/rss_matmul.cu``, B3 ``csrc/bin_rss_matmul.cu``) have
other choices, and a :class:`KernelConfig` names them:

* ``route``: the int8 tensor cores over the limbs (``limbs.TENSOR_CORE``)
  or the 32-bit words on the CUDA cores (``limbs.CUDA_CORE``); ``None``
  follows :func:`~.limbs.limb_mma_plan`;
* ``splits``: the split-K count of the tensor-core route (its blocks add
  with int32 atomics, so any count gives the same words);
* ``bn``: B3's CUDA-core tile width, 16, 32 or 64 (``None``: by N, as the
  kernel picks it).

Every choice computes the same words mod 2^32, so a config changes time,
never values.  :data:`DEFAULT_CONFIG` (all ``None``) is the plan, so an
empty autotune cache changes nothing.  :data:`PLAIN` names the plain
PyTorch version, the only lowering of a CPU tensor; a CUDA tensor never
takes it (the kernel wrappers raise).  The grouped kernels (B2, B4) have no
launch choice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from .limbs import CUDA_CORE, K_STAGE, TENSOR_CORE, limb_mma_plan

__all__ = ["KernelConfig", "DEFAULT_CONFIG", "PLAIN", "BN_CHOICES",
           "bn_for", "plan_config", "resolve", "normalize"]

PLAIN = "plain"
# B3's CUDA-core tile widths (csrc/bin_rss_matmul.cu: BN = 16 * TN)
BN_CHOICES = (16, 32, 64)


class KernelConfig(NamedTuple):
    """One launch choice of B1 or B3 (``None`` fields follow the plan)."""

    route: Optional[str] = None
    splits: Optional[int] = None
    bn: Optional[int] = None

    def describe(self) -> str:
        if self.route is None:
            return "plan"
        if self.route == PLAIN:
            return "plain"
        if self.route == TENSOR_CORE:
            return f"{TENSOR_CORE} split-K {self.splits or 1}"
        return CUDA_CORE + (f" bn={self.bn}" if self.bn else "")


DEFAULT_CONFIG = KernelConfig()


def bn_for(n: int) -> int:
    """The CUDA-core tile width B3 picks from N when none is given."""
    return 16 if n <= 16 else 32 if n <= 32 else 64


def resolve(cfg: KernelConfig | None, s: int, m: int, k: int, n: int,
            sms: int, family: str) -> tuple[str, int, int]:
    """(route, K stages per split, bn) of one launch: the plan's where
    ``cfg`` is ``None`` or leaves the route open, else the config's (one
    split where it names none; bn 0 = by N)."""
    if cfg is None or cfg.route is None:
        route, per, _ = limb_mma_plan(s, m, k, n, sms)
        return route, per, 0
    if cfg.route == PLAIN:
        raise ValueError(f"{family}: the plain version runs on CPU tensors "
                         f"only; on the card the kernel is the only route")
    if cfg.route not in (TENSOR_CORE, CUDA_CORE):
        raise ValueError(f"{family}: unknown route {cfg.route!r}")
    bn = cfg.bn or 0
    if bn and (family != "bin_rss_matmul" or cfg.route != CUDA_CORE
               or bn not in BN_CHOICES):
        raise ValueError(f"{family}: bn={bn} applies to bin_rss_matmul's "
                         f"{CUDA_CORE} route only, one of {BN_CHOICES}")
    steps = -(-k // K_STAGE)
    return cfg.route, -(-steps // normalize(cfg, k).splits), bn


def normalize(cfg: KernelConfig, k: int) -> KernelConfig:
    """``cfg`` with the split count its launch runs: K stages per split
    are ceil(stages / splits), so several counts give one launch; the CUDA
    cores take one split."""
    if cfg.route != TENSOR_CORE:
        return cfg._replace(splits=1) if cfg.route == CUDA_CORE else cfg
    steps = -(-k // K_STAGE)
    per = -(-steps // max(1, min(cfg.splits or 1, steps)))
    return cfg._replace(splits=-(-steps // per))


def plan_config(family: str, s: int, m: int, k: int, n: int,
                sms: int) -> KernelConfig:
    """The plan's choice as a concrete config (what ``DEFAULT_CONFIG``
    runs): its route, its split count, and B3's width from N."""
    route, per, splits = limb_mma_plan(s, m, k, n, sms)
    if route == TENSOR_CORE:
        return KernelConfig(TENSOR_CORE, splits)
    return KernelConfig(CUDA_CORE, 1,
                        bn_for(n) if family == "bin_rss_matmul" else None)
