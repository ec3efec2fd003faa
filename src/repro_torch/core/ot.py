"""Three-party oblivious transfer (paper Algorithm 1).

Port of ``repro/core/ot.py::ot3``.  The sender and receiver share the PRF
masks (mask0, mask1); the sender sends both masked messages to the helper,
who forwards the chosen one; the receiver unmasks.  2 rounds, 3 ring
elements per slot, vectorised over whole tensors.
"""
from __future__ import annotations

import torch

from . import comm, transport
from .randomness import Parties
from .ring import RingSpec, default_ring

__all__ = ["ot3", "pair_key_index"]


def pair_key_index(a: int, b: int) -> int:
    """PRF key index shared by parties a and b (P_i holds (k_i, k_{i+1}))."""
    if (a + 1) % 3 == b:
        return b
    if (b + 1) % 3 == a:
        return a
    raise ValueError(f"no common key for pair ({a},{b})")


def ot3(m0, m1, choice_shares, choice_slot: int, *, sender: int,
        receiver: int, helper: int, parties: Parties,
        ring: RingSpec | None = None, tag: str = "ot3",
        preprocess: bool = False):
    """Transfer m_c for the choice bit ``choice_shares[choice_slot]``
    (the share slot the sender does not hold).  Returns the receiver's
    m_c."""
    ring = ring or default_ring()
    t = transport.current()
    cb = t.slot_view(choice_shares, choice_slot).to(torch.bool)
    mask0, mask1 = parties.ot_masks(pair_key_index(sender, receiver),
                                    m0.shape, ring)
    comm.record(tag, rounds=2, nbytes=3 * m0.numel() * ring.nbytes,
                preprocess=preprocess)
    s0 = t.send(m0 ^ mask0, sender, helper)
    s1 = t.send(m1 ^ mask1, sender, helper)
    sc = t.send(torch.where(cb, s1, s0), helper, receiver)
    return sc ^ torch.where(cb, mask1, mask0)
