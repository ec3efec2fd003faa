"""Secure Sign and ReLU (paper Algorithms 4 and 5, DESIGN.md §8).

Port of ``repro/core/activation.py`` (``sign_from_msb``,
``sign_from_msb_arith``, ``relu_from_msb_arith``, ``secure_sign``,
``_bit_times_value_ot``, ``relu_from_msb``, ``secure_relu``,
``select_from_msb``).  Sign outputs the indicator s = 1 ⊕ MSB(x) ∈ {0,1}
as arithmetic shares.

Fused rounds (the default): with [MSB]^A from ``msb_extract_arith`` the
Sign indicator is 1 − [MSB]^A (zero online rounds) and ReLU is one secure
multiplication by that gate.  Paper-faithful (``set_fused_rounds(False)``):
Sign converts the binary MSB shares by the 3-party OT, landing directly in
RSS layout plus one forward; ReLU runs two parallel bit-times-value OTs and
one reshare.
"""
from __future__ import annotations

import math

from . import comm, transport
from .linear import _reshare, fused_rounds, mul
from .msb import DEFAULT_BOUND_BITS, msb_extract, msb_extract_arith
from .ot import ot3
from .randomness import Parties
from .ring import RingSpec
from .rss import RSS, BinRSS, PARTIES

__all__ = ["secure_sign", "secure_relu", "sign_from_msb", "relu_from_msb",
           "sign_from_msb_arith", "relu_from_msb_arith", "select_from_msb"]


def sign_from_msb(msb: BinRSS, parties: Parties, ring: RingSpec,
                  tag: str = "sign") -> RSS:
    """Algorithm 4: arithmetic RSS of 1 ⊕ MSB(x) from its binary shares.

    β1 (common to P0, P1) and β2 (common to P1, P2) mask the messages
    m_j = (1 ⊕ j ⊕ MSB_1 ⊕ MSB_2) − β1 − β2 of sender P1; the OT (receiver
    P0, helper P2, choice MSB_0) gives P0 m_c = (1 ⊕ MSB) − β1 − β2, which
    P0 forwards to P2.  Slots (m_c, β1, β2) are a valid RSS."""
    t = transport.current()
    shape = msb.shape
    beta1 = parties.common_pair(0, 1, shape, ring)
    beta2 = parties.common_pair(1, 2, shape, ring)
    b12 = t.slot_view(msb.shares, 1) ^ t.slot_view(msb.shares, 2)
    base = (1 ^ b12).to(ring.dtype)
    m0 = base - beta1 - beta2
    m1 = (base ^ 1) - beta1 - beta2
    mc = ot3(m0, m1, msb.shares, 0, sender=1, receiver=0, helper=2,
             parties=parties, ring=ring, tag=tag + ".ot")
    n = math.prod(int(d) for d in shape)
    comm.record(tag + ".fwd", rounds=1, nbytes=n * ring.nbytes)
    mc_fwd = t.send(mc, 0, 2)
    slot0 = t.merge_recv(mc, mc_fwd, holder=2)
    return RSS(t.build_rss([slot0, beta1, beta2]), ring)


def sign_from_msb_arith(msb_a: RSS) -> RSS:
    """{0,1} indicator 1 ⊕ MSB(x) = 1 − [MSB]^A, local."""
    return (-msb_a).add_public(1)


def relu_from_msb_arith(x: RSS, msb_a: RSS, parties: Parties,
                        tag: str = "relu") -> RSS:
    """Fused Alg 5: ReLU(x) = (1 − [MSB]^A)·x as ONE secure mult round;
    the {0,1} gate is at scale 0, so the product keeps x's scale."""
    gate = sign_from_msb_arith(msb_a)
    return mul(gate, x, parties, tag=tag + ".gate")


def secure_sign(x: RSS, parties: Parties,
                bound_bits: int = DEFAULT_BOUND_BITS,
                tag: str = "sign") -> RSS:
    """Sign activation (Alg 3 + Alg 4), output ∈ {0,1}."""
    if fused_rounds():
        _, msb_a = msb_extract_arith(x, parties, bound_bits=bound_bits,
                                     tag=tag + ".msb")
        return sign_from_msb_arith(msb_a)
    msb = msb_extract(x, parties, bound_bits=bound_bits, tag=tag + ".msb")
    return sign_from_msb(msb, parties, x.ring, tag=tag)


def _bit_times_value_ot(msb: BinRSS, value, *, sender: int, receiver: int,
                        helper: int, parties: Parties, ring: RingSpec,
                        complement: bool, tag: str):
    """Shared core of Alg 5: OT-transfer (c ⊕ bits)·value − masks, where
    ``value`` is known to ``sender``.  Returns (receiver's share, sender's
    private mask, the sender–helper common mask)."""
    t = transport.current()
    s_view = [(sender + k) % PARTIES for k in (0, 1)]
    # the sender holds two MSB share slots; receiver and helper the third
    other = 3 - sum(s_view) if set(s_view) != {0, 2} else 1
    bs = t.slot_view(msb.shares, s_view[0]) ^ t.slot_view(msb.shares,
                                                          s_view[1])
    shape = bs.shape
    mask_a = parties.private_to(sender, shape, ring)
    mask_b = parties.common_pair(sender, helper, shape, ring)
    sel0 = ((1 if complement else 0) ^ bs).to(ring.dtype)
    sel1 = sel0 ^ 1
    m0 = sel0 * value - mask_a - mask_b
    m1 = sel1 * value - mask_a - mask_b
    mc = ot3(m0, m1, msb.shares, other, sender=sender, receiver=receiver,
             helper=helper, parties=parties, ring=ring, tag=tag)
    return mc, mask_a, mask_b


def relu_from_msb(x: RSS, msb: BinRSS, parties: Parties,
                  tag: str = "relu") -> RSS:
    """Algorithm 5: [ReLU(x)]^A = [(1 ⊕ MSB(x))·x]^A via two parallel OTs
    (OT-A: sender P1, receiver P0, helper P2 transfers (1⊕MSB)·(x1+x2);
    OT-B: sender P0, receiver P2, helper P1 transfers (1⊕MSB)·x0) in the
    same 2 rounds, then one reshare back to RSS."""
    ring = x.ring
    t = transport.current()
    with comm.round_barrier(tag + ".ots", rounds=2):
        a_recv, a_m1, a_m2 = _bit_times_value_ot(
            msb, t.slot_view(x.shares, 1) + t.slot_view(x.shares, 2),
            sender=1, receiver=0, helper=2, parties=parties, ring=ring,
            complement=True, tag=tag + ".otA")
        b_recv, b_m0, b_m1 = _bit_times_value_ot(
            msb, t.slot_view(x.shares, 0), sender=0, receiver=2, helper=1,
            parties=parties, ring=ring, complement=True, tag=tag + ".otB")
    # additive recombination: P0 a_recv + b_m0, P1 a_m1 + b_m1,
    # P2 a_m2 + b_recv
    z = t.build_parts([a_recv + b_m0, a_m1 + b_m1, a_m2 + b_recv])
    return _reshare(z, ring, parties, tag + ".reshare")


def secure_relu(x: RSS, parties: Parties,
                bound_bits: int = DEFAULT_BOUND_BITS,
                tag: str = "relu") -> RSS:
    """ReLU: Alg 3 + Alg 5 (fused: 2 online rounds; paper: 5)."""
    if fused_rounds():
        _, msb_a = msb_extract_arith(x, parties, bound_bits=bound_bits,
                                     tag=tag + ".msb")
        return relu_from_msb_arith(x, msb_a, parties, tag=tag)
    msb = msb_extract(x, parties, bound_bits=bound_bits, tag=tag + ".msb")
    return relu_from_msb(x, msb, parties, tag=tag)


def select_from_msb(a: RSS, b: RSS, msb: BinRSS, parties: Parties,
                    tag: str = "select") -> RSS:
    """Oblivious select: a where MSB == 0 else b, = b + (1⊕MSB)·(a − b)."""
    return b + relu_from_msb(a - b, msb, parties, tag=tag)
