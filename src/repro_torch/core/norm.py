"""Batch-normalisation fusing (paper §3.5) and secure RMSNorm.

Port of ``repro/core/norm.py``: the model-owner folds
(``fuse_bn_sign_threshold``, ``fuse_bn_linear``) in numpy with the
reference's arithmetic, so the folded values (and the shares drawn from
them) are bit-identical; and the secure half (``_mul_tr``, ``_sq_tr``,
``apply_sign_bn_shift``, ``newton_reciprocal``, ``newton_rsqrt``,
``secure_rmsnorm``), which draws the PRF and records the ledger rows in the
reference's order, so shares, tags, rounds and bytes are the reference's on
RING32 and RING64.

RMSNorm (transformer substrate, beyond the paper):
y = x · rsqrt(mean(x²) + ε) · g.  mean(x²) is one secure square and a
local sum; rsqrt is Newton–Raphson from a public start.
"""
from __future__ import annotations

import numpy as np
import torch

from .linear import (fused_rounds, mul, mul_truncate, square,
                     square_truncate, truncate)
from .randomness import Parties
from .rss import RSS, PARTIES, public_rss

__all__ = ["fuse_bn_sign_threshold", "fuse_bn_linear", "apply_sign_bn_shift",
           "secure_rmsnorm", "newton_rsqrt", "newton_reciprocal"]


def _f32(v: float) -> torch.Tensor:
    """A public constant as the reference's ``jnp.float32(v)``."""
    return torch.tensor(v, dtype=torch.float32)


def _mul_tr(a: RSS, b: RSS, parties, tag: str, frac: int | None = None):
    """mul + trunc: one fused round when the beyond-paper mode is on."""
    if fused_rounds():
        return mul_truncate(a, b, parties, frac=frac, tag=tag)
    return truncate(mul(a, b, parties, tag=tag), parties, frac=frac,
                    tag=tag + ".t")


def _sq_tr(a: RSS, parties, tag: str, frac: int | None = None):
    if fused_rounds():
        return square_truncate(a, parties, frac=frac, tag=tag)
    return truncate(square(a, parties, tag=tag), parties, frac=frac,
                    tag=tag + ".t")


# ---------------------------------------------------------------------------
# Paper §3.5: the two fusing modes
# ---------------------------------------------------------------------------

def fuse_bn_sign_threshold(gamma, beta, mean, var, eps: float = 1e-5):
    """BN followed by Sign -> per-channel threshold shift t = β'/γ' with
    γ' = γ/√(σ²+ε) > 0 (paper eq. 8)."""
    gp = gamma / np.sqrt(var + eps)
    bp = beta - gamma * mean / np.sqrt(var + eps)
    if np.any(gp <= 0):
        raise ValueError("BN-Sign fusing requires γ' > 0 (paper eq. 8)")
    return bp / gp


def fuse_bn_linear(w, b, gamma, beta, mean, var, eps: float = 1e-5):
    """BN after a linear layer folds into (W, b) (paper eqs. 10–11)."""
    s = gamma / np.sqrt(var + eps)
    return w * s, beta + (b - mean) * s


def apply_sign_bn_shift(x: RSS, t_shares: RSS) -> RSS:
    """Online part of BN→Sign fusing: add the pre-shared threshold. Local."""
    tsh = t_shares.shares.reshape((PARTIES,) + (1,) * (x.ndim - 1) + (-1,))
    return RSS(x.shares + tsh, x.ring)


# ---------------------------------------------------------------------------
# Newton iterations (substrate for RMSNorm and the softmax denominator)
# ---------------------------------------------------------------------------

def newton_reciprocal(d: RSS, parties: Parties, iters: int = 14,
                      init: float = 2.0 ** -10, tag: str = "recip") -> RSS:
    """1/d for d in (0, 2^10): y_{k+1} = y_k (2 - d y_k), from the public
    y_0 = 2^-10 (0 < y_0 < 2/d over the range)."""
    ring = d.ring
    y = public_rss(ring.encode(_f32(init)), d.shape, ring, d.device)
    two = ring.encode(_f32(2.0))
    for k in range(iters):
        dy = _mul_tr(d, y, parties, f"{tag}.mul{k}")
        corr = public_rss(two, d.shape, ring, d.device) - dy
        y = _mul_tr(y, corr, parties, f"{tag}.mul{k}b")
    return y


def newton_rsqrt(d: RSS, parties: Parties, iters: int = 14,
                 init: float = 0.2, tag: str = "rsqrt") -> RSS:
    """1/√d: y_{k+1} = y_k (3 - d y_k²) / 2, the ×1/2 fused into the last
    multiply's shift.  y_0 = 0.2 converges for d < 75; RMSNorm's operands
    lie in (0.05, 8)."""
    ring = d.ring
    y = public_rss(ring.encode(_f32(init)), d.shape, ring, d.device)
    three = ring.encode(_f32(3.0))
    for k in range(iters):
        y2 = _sq_tr(y, parties, f"{tag}.sq{k}")
        dy2 = _mul_tr(d, y2, parties, f"{tag}.mul{k}")
        corr = public_rss(three, d.shape, ring, d.device) - dy2
        y = _mul_tr(y, corr, parties, f"{tag}.mul{k}b",
                    frac=ring.frac + 1)
    return y


def secure_rmsnorm(x: RSS, gain: RSS, parties: Parties, eps: float = 1e-5,
                   tag: str = "rmsnorm") -> RSS:
    """y = x · rsqrt(mean(x², axis=-1) + ε) · g."""
    ring = x.ring
    n = int(x.shape[-1])
    x2 = _sq_tr(x, parties, tag + ".sq")
    ms = x2.sum(axis=-1, keepdims=True)
    # the public 1/n in fixed point, then a truncation
    inv_n = ring.encode(_f32(1.0 / n))
    ms = truncate(ms.mul_public_int(inv_n), parties, tag=tag + ".trn")
    ms = ms.add_public(_f32(eps))
    r = newton_rsqrt(ms, parties, tag=tag + ".rsqrt")
    xn = _mul_tr(x, r, parties, tag + ".mulr")
    return _mul_tr(xn, gain, parties, tag + ".mulg")
