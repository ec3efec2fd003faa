"""Batch-normalisation folds (paper §3.5), model-owner side, in numpy.

Port of ``repro/core/norm.py`` (``fuse_bn_sign_threshold``,
``fuse_bn_linear``).  They run on the plaintext parameters at compile time
with the reference's numpy arithmetic, so the folded values (and so the
shares drawn from them) are bit-identical.  Secure RMSNorm belongs to the
LM slice.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fuse_bn_sign_threshold", "fuse_bn_linear"]


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
