"""Sign→maxpool fusion (paper §3.6).

Port of ``repro/core/pooling.py`` (``_window_split``,
``sign_maxpool_fused``).  After a Sign layer the window holds {0,1} bits:
max == OR == [window sum − 1 ≥ 0], one MSB extraction per window.  The
general pairwise-max ``secure_maxpool`` (ReLU nets) belongs to a later
slice.
"""
from __future__ import annotations

from .activation import sign_from_msb_arith
from .msb import msb_extract_arith
from .randomness import Parties
from .rss import RSS

__all__ = ["sign_maxpool_fused"]


def _window_split(x: RSS, pool: int):
    """(B, H, W, C) -> list of pool*pool RSS slices aligned per window."""
    b, h, w, c = x.shape
    assert h % pool == 0 and w % pool == 0
    slots = x.shares.shape[0]
    sh = x.shares.reshape(slots, b, h // pool, pool, w // pool, pool, c)
    return [RSS(sh[:, :, :, i, :, j, :], x.ring)
            for i in range(pool) for j in range(pool)]


def sign_maxpool_fused(sign_bits: RSS, parties: Parties, pool: int = 2,
                       tag: str = "signmax") -> RSS:
    """out = 1 ⊕ MSB(Σ_window bits − 1), one MSB extraction per window."""
    parts = _window_split(sign_bits, pool)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    acc = acc.add_public(-1)
    # window sums are tiny integers: tight bound, most headroom for the mask
    _, msb_a = msb_extract_arith(acc, parties, bound_bits=4,
                                 tag=tag + ".msb")
    return sign_from_msb_arith(msb_a)
