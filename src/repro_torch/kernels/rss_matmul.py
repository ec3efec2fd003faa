"""The fused 3-party RSS matmul: wrapper, plain version and weight cache.

Port of ``repro/kernels/rss_matmul.py`` (``WeightLimbs``,
``precompute_weight_limbs``, ``rss_matmul_parts_ref``,
``rss_matmul_parts``).  Per party i the secure linear layer needs

    z_i = x_i @ (w_i + w_{i+1}) + x_{i+1} @ w_i        (mod 2^32)

On a CUDA tensor :func:`rss_matmul_parts` launches the hand-written kernel
``csrc/rss_matmul.cu`` (it replaces the TPU kernel
``repro/kernels/rss_matmul.py::_rss_matmul_kernel``) or raises; on a CPU
(or ``meta``) tensor it runs the plain version, per-party int32 matmuls
that wrap mod 2^32.  torch has no integer matmul on CUDA, so the plain
version is CPU-only.  The kernel takes the route of
:func:`~.limbs.limb_mma_plan`: the int8 tensor cores over the limbs
(split-K where the tile grid leaves SMs idle), or at K <= 16 the CUDA
cores on the int32 words; a ``cfg`` (``lowering.KernelConfig``, from the
autotuner's cache) replaces the plan's choice.

``WeightLimbs`` keeps the reference's cache exactly: the int32 stacks
``ws`` / ``wf`` (the CUDA-core route's operands) and their balanced int8
limbs ``wl`` / ``wfl``, 128-padded as in the reference.  It adds ``wt``,
the same limbs K-major, the tensor-core route's operand.
"""
from __future__ import annotations

import typing

import torch
import torch.nn.functional as F

from . import build
from .limbs import TENSOR_CORE, balanced_limbs, sm_count
from .lowering import KernelConfig, resolve

__all__ = ["WeightLimbs", "precompute_weight_limbs", "rss_matmul_parts",
           "rss_matmul_parts_ref"]

_TILE = 128


class WeightLimbs(typing.NamedTuple):
    """Cached per-layer weight-share operands, computed once at setup."""

    ws: torch.Tensor   # (3, K, N) int32 — w_i
    wf: torch.Tensor   # (3, K, N) int32 — fused operand w_i + w_{i+1}
    wl: torch.Tensor   # (3, 4, Kp, Np) int8 — limbs of ws, 128-padded
    wfl: torch.Tensor  # (3, 4, Kp, Np) int8 — limbs of wf, 128-padded
    wt: torch.Tensor   # (3, 2, 4, Np, Kp) int8 — wfl and wl, K-major

    @property
    def k(self) -> int:
        return self.ws.shape[1]

    @property
    def n(self) -> int:
        return self.ws.shape[2]


def _pad_to(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % m
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def _stack_limbs(stack: torch.Tensor) -> torch.Tensor:
    """(3, A, B) int32 -> (3, 4, A, B) int8."""
    return balanced_limbs(stack).transpose(0, 1).contiguous()


def precompute_weight_limbs(w_shares: torch.Tensor) -> WeightLimbs:
    """Cache a (3, K, N) weight-share stack and its fused operand."""
    ws = w_shares.contiguous()
    wf = ws + torch.roll(ws, -1, dims=0)
    pad = lambda a: _pad_to(_pad_to(a, _TILE, 1), _TILE, 2)
    wl, wfl = _stack_limbs(pad(ws)), _stack_limbs(pad(wf))
    wt = torch.stack([wfl, wl], dim=1).transpose(-1, -2).contiguous()
    return WeightLimbs(ws=ws, wf=wf, wl=wl, wfl=wfl, wt=wt)


def rss_matmul_parts_ref(x_stack: torch.Tensor,
                         weights: WeightLimbs) -> torch.Tensor:
    """Plain version: per-party int32 matmuls on the cached fused operand
    (CPU / meta tensors only)."""
    xn = torch.roll(x_stack, -1, dims=0)
    return torch.matmul(x_stack, weights.wf) + torch.matmul(xn, weights.ws)


def _launch(x_stack: torch.Tensor, weights: WeightLimbs,
            cfg: KernelConfig | None = None) -> torch.Tensor:
    """Launch the kernel on the plan's route and split, or on ``cfg``'s
    (the autotuner and ``chip_smoke.py`` run and time the others)."""
    s, m, k = x_stack.shape
    n = weights.n
    for name, t, dtype in (("x", x_stack, torch.int32),
                           ("ws", weights.ws, torch.int32),
                           ("wf", weights.wf, torch.int32),
                           ("wt", weights.wt, torch.int8)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != x_stack.device:
            raise ValueError(f"rss_matmul: {name} must be a contiguous "
                             f"{dtype} tensor on {x_stack.device}")
    if tuple(weights.ws.shape) != (s, k, n):
        raise ValueError(f"rss_matmul: weights {tuple(weights.ws.shape)} "
                         f"do not match x {tuple(x_stack.shape)}")
    np_, kp = weights.wt.shape[-2:]
    if tuple(weights.wt.shape) != (s, 2, 4, np_, kp) or np_ % _TILE \
            or kp % _TILE or np_ < n or kp < k:
        raise ValueError(f"rss_matmul: wt {tuple(weights.wt.shape)} is not "
                         f"the 128-padded K-major limb cache of {(s, k, n)}")
    out = torch.empty((s, m, n), dtype=torch.int32, device=x_stack.device)
    if out.numel() == 0:
        return out
    chosen, per, _ = resolve(cfg, s, m, k, n, sm_count(x_stack.device),
                             "rss_matmul")
    fn = build.library("rss_matmul")
    err = fn(x_stack.data_ptr(), weights.wf.data_ptr(), weights.ws.data_ptr(),
             weights.wt.data_ptr(), out.data_ptr(), s, m, k, n, kp, np_,
             int(chosen == TENSOR_CORE), per, build.stream_ptr(x_stack.device))
    build.check("rss_matmul", err)
    build.LAUNCHES["rss_matmul"] += 1
    return out


def rss_matmul_parts(x_stack: torch.Tensor, weights: WeightLimbs,
                     cfg: KernelConfig | None = None) -> torch.Tensor:
    """All parties' additive products z_i, (S, M, K) -> (S, M, N) int32.

    CUDA tensors launch the kernel (on ``cfg``'s choice if given) or
    raise; CPU and meta tensors run the plain version (``cfg`` has no
    choice to make there)."""
    assert x_stack.shape[2] == weights.k, (x_stack.shape, weights.ws.shape)
    if x_stack.device.type == "cuda":
        return _launch(x_stack, weights, cfg)
    if x_stack.device.type in ("cpu", "meta"):
        return rss_matmul_parts_ref(x_stack, weights)
    raise ValueError(f"rss_matmul: unsupported device {x_stack.device}")
