"""Secure softmax and its customized replacement (transformer substrate).

Port of ``repro/core/softmax.py`` (``secure_exp``, ``secure_softmax``,
``relu_attention_scores``, ``secure_argmax_onehot``): the same PRF draws in
the same order and the same ledger rows, so shares, tags, rounds and bytes
are the reference's.

CBNN's answer to softmax is customization: replace it with an MPC-friendly
form and distill (paper §3.1).  Both are here:

  * relu_attention_scores - the customized path: ReLU(s)/L needs only the
    paper's Alg 3+5 and a public multiply;
  * secure_softmax - the full softmax for un-customized models: a max
    tournament (MSB compares), a range-reduced exp through
    (1 + z/2^k)^{2^k} (k secure squarings), a Newton reciprocal of the
    denominator.
"""
from __future__ import annotations

from .activation import secure_relu, sign_from_msb
from .linear import truncate
from .msb import DEFAULT_BOUND_BITS, msb_extract
from .norm import _f32, _mul_tr, _sq_tr, newton_reciprocal
from .pooling import secure_max_lastdim
from .randomness import Parties
from .rss import RSS

__all__ = ["secure_exp", "secure_softmax", "relu_attention_scores",
           "secure_argmax_onehot"]


def secure_exp(z: RSS, parties: Parties, k: int = 6, tag: str = "exp") -> RSS:
    """e^z for z in [-16, 0] by (1 + z/2^k)^{2^k}: k secure squarings."""
    ring = z.ring
    # z / 2^k: a local share shift is biased, so public multiply + truncate
    base = truncate(z.mul_public_int(ring.encode(_f32(2.0 ** -k))),
                    parties, tag=tag + ".scale")
    y = base.add_public(_f32(1.0))
    for i in range(k):
        y = _sq_tr(y, parties, f"{tag}.sq{i}")
    return y


def secure_softmax(x: RSS, parties: Parties,
                   bound_bits: int = DEFAULT_BOUND_BITS,
                   tag: str = "softmax") -> RSS:
    """Softmax over the last dim; the RSS of the probabilities."""
    m = secure_max_lastdim(x, parties, bound_bits=bound_bits, tag=tag + ".max")
    z = x - RSS(m.shares.expand(x.shares.shape), x.ring)
    e = secure_exp(z, parties, tag=tag + ".exp")
    denom = e.sum(axis=-1, keepdims=True)
    inv = newton_reciprocal(denom, parties, tag=tag + ".recip")
    return _mul_tr(e, inv, parties, tag + ".mul")


def relu_attention_scores(scores: RSS, seq_len: int, parties: Parties,
                          bound_bits: int = DEFAULT_BOUND_BITS,
                          tag: str = "reluattn") -> RSS:
    """Customized attention normalisation: ReLU(s) / L.  Alg 3+5 and one
    public fixed-point multiply; no max, exp or division."""
    ring = scores.ring
    r = secure_relu(scores, parties, bound_bits=bound_bits, tag=tag + ".relu")
    inv_l = ring.encode(_f32(1.0 / seq_len))
    return truncate(r.mul_public_int(inv_l), parties, tag=tag + ".tr")


def secure_argmax_onehot(x: RSS, parties: Parties,
                         bound_bits: int = DEFAULT_BOUND_BITS,
                         tag: str = "argmax") -> RSS:
    """One-hot of the argmax over the last dim: MSB(max − x − 1) is 1
    exactly at the max (the differences are integers >= 0).  Ties give a
    multi-hot row, as in the reference."""
    m = secure_max_lastdim(x, parties, bound_bits=bound_bits, tag=tag + ".max")
    diff = RSS(m.shares.expand(x.shares.shape), x.ring) - x
    msb = msb_extract(diff.add_public(-1), parties, bound_bits=bound_bits,
                      tag=tag + ".msb")
    # sign_from_msb gives 1 ⊕ MSB: the one-hot is its complement
    not_m = sign_from_msb(msb, parties, x.ring, tag=tag + ".b2a")
    return (-not_m).add_public(1)
