"""Secure Sign activation, fused rounds (paper Algorithm 4, DESIGN.md §8).

Port of ``repro/core/activation.py::sign_from_msb_arith``.  With [MSB]^A in
hand (``msb_extract_arith``) the {0,1} Sign indicator is 1 − [MSB]^A: zero
online rounds.  The OT forms (``sign_from_msb``, ``relu_from_msb``) belong
to a later slice.
"""
from __future__ import annotations

from .rss import RSS

__all__ = ["sign_from_msb_arith"]


def sign_from_msb_arith(msb_a: RSS) -> RSS:
    """{0,1} indicator 1 ⊕ MSB(x) = 1 − [MSB]^A, local."""
    return (-msb_a).add_public(1)
