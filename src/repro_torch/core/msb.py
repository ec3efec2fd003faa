"""MSB extraction without bit decomposition (paper Algorithm 3) and the
B2A share conversion (paper §3.3) via the 3-party OT.

Port of ``repro/core/msb.py`` (``b2a``, ``_msb_core``, ``msb_extract``,
``msb_extract_arith``, ``a2b_msb``, ``DEFAULT_BOUND_BITS``):

  offline : random bit [β]^B, its B2A conversion [β]^A, a positive odd
            bounded mask [r], and [ρ] = [(−1)^β · r];
  online  : y = 2x + 1, u = y·ρ multiplied and opened in ONE round with
            fused rounds (``mul_open``), or paper-faithful in two
            (``mul`` then ``reveal``); β' = MSB(u) public,
            [MSB(x)]^B = [β]^B ⊕ β'.

Correctness needs |2x+1|·r < 2^{l-1}: r < 2^{r_bits} with
r_bits = l − 2 − (bound_bits + 1) for |x| < 2^bound_bits.
"""
from __future__ import annotations

import math

from . import comm, transport
from .linear import fused_rounds, mul, mul_open, reveal
from .ot import ot3
from .randomness import Parties
from .ring import RingSpec
from .rss import RSS, BinRSS

__all__ = ["b2a", "msb_extract", "msb_extract_arith", "a2b_msb",
           "DEFAULT_BOUND_BITS"]

DEFAULT_BOUND_BITS = 18


def b2a(bit: BinRSS, parties: Parties, ring: RingSpec,
        preprocess: bool = False, tag: str = "b2a") -> RSS:
    """XOR shares of a bit -> arithmetic RSS of the same bit.  Sender P1,
    receiver P0, helper P2; the additive (m_c, α1, α2) is reshared."""
    t = transport.current()
    shape = bit.shape
    alpha1 = parties.private_to(1, shape, ring)
    alpha2 = parties.common_pair(1, 2, shape, ring)
    bxor12 = (t.slot_view(bit.shares, 1) ^ t.slot_view(bit.shares, 2)).to(
        ring.dtype)
    m0 = bxor12 - alpha1 - alpha2
    m1 = (bxor12 ^ 1) - alpha1 - alpha2
    mc = ot3(m0, m1, bit.shares, 0, sender=1, receiver=0, helper=2,
             parties=parties, ring=ring, tag=tag + ".ot",
             preprocess=preprocess)
    z = t.build_parts([mc, alpha1, alpha2])
    n = math.prod(int(d) for d in shape)
    comm.record(tag + ".reshare", rounds=1, nbytes=3 * n * ring.nbytes,
                preprocess=preprocess)
    return RSS(t.complete(z), ring)


def _msb_core(x: RSS, parties: Parties, bound_bits: int, tag: str):
    """Algorithm 3 body: ([β]^B, [β]^A, β') with MSB(x) = β ⊕ β'."""
    ring = x.ring
    r_bits = ring.bits - 2 - (bound_bits + 1)
    if r_bits < 1:
        raise ValueError(f"bound_bits={bound_bits} too large for l={ring.bits}")
    beta, beta_a, rho = parties.msb_material(x.shape, ring, r_bits, tag=tag)
    y = x.mul_public_int(2).add_public(1)              # 2x+1, odd
    if fused_rounds():
        u_pub = mul_open(y, rho, parties, tag=tag + ".mulopen")
    else:
        u = mul(y, rho, parties, tag=tag + ".mul")
        u_pub = reveal(u, tag=tag + ".reveal")
    return beta, beta_a, ring.msb(u_pub)


def msb_extract(x: RSS, parties: Parties,
                bound_bits: int = DEFAULT_BOUND_BITS,
                tag: str = "msb") -> BinRSS:
    """Binary shares of MSB(x) for |x| < 2^bound_bits."""
    beta, _, beta_prime = _msb_core(x, parties, bound_bits, tag)
    return beta ^ beta_prime


def msb_extract_arith(x: RSS, parties: Parties,
                      bound_bits: int = DEFAULT_BOUND_BITS,
                      tag: str = "msb") -> tuple[BinRSS, RSS]:
    """MSB(x) as binary AND arithmetic shares for the same online cost:
    [MSB]^A = β' + (1 − 2β')·[β]^A, derived locally."""
    ring = x.ring
    beta, beta_a, beta_prime = _msb_core(x, parties, bound_bits, tag)
    bp = beta_prime.to(ring.dtype)
    arith = RSS(beta_a.shares * (1 - 2 * bp), ring).add_public(bp)
    return beta ^ beta_prime, arith


def a2b_msb(x: RSS, parties: Parties,
            bound_bits: int = DEFAULT_BOUND_BITS) -> BinRSS:
    """Paper §3.3: the arithmetic -> binary conversion CBNN needs is the
    MSB bit, produced inside the MSB extraction."""
    return msb_extract(x, parties, bound_bits=bound_bits)
