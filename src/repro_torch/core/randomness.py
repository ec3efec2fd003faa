"""PRF-based correlated randomness (paper §3.2).

Port of ``repro/core/randomness.py::Parties`` in full: the ``fresh()``
counter base, ``zero_shares``, ``rand_rss`` (with ``max_bits``),
``rand_rss_open``, ``rand_bits``, ``common_pair``, ``private_to``,
``ot_masks`` (second mask at counter + 100003) and ``msb_material``.
RING64 words are two 32-bit draws, as in the reference
(``prf.ring_bits``).  Each party pair shares a PRF
key; a monotone counter folded into the key gives freshness, consumed in
exactly the reference's order so every draw is bit-identical.  The
``device`` is where the draws land.  Every draw evaluates the PRF through
:meth:`Parties._stream` (the reference's ``_prf_bits``), one batched
evaluation over the (key index, counter) pairs it needs; the offline plant
overrides it to draw many queries' keys at once.

  3-out-of-3 randomness:  a_i = F(k_{i+1}, cnt) - F(k_i, cnt)   =>  Σ a_i = 0
  2-out-of-3 randomness:  (a_i, a_{i+1}) = (F(k_i, cnt), F(k_{i+1}, cnt))
"""
from __future__ import annotations

import dataclasses
import torch

from . import prf, transport
from .ring import RingSpec, default_ring
from .rss import RSS, BinRSS, PARTIES

__all__ = ["Parties", "party_keys"]


def party_keys(keys, pid: int) -> list:
    """What P_pid holds of the three keys: k_pid and k_{pid+1}, each shared
    with one neighbour, and ``None`` in the third slot."""
    return [tuple(k) if i in (pid, (pid + 1) % PARTIES) else None
            for i, k in enumerate(keys)]


@dataclasses.dataclass
class Parties:
    """The three-party setup: PRF keys + freshness counter.

    ``keys[i]`` is k_i (shared between P_i and P_{i+1}).  Program entry
    points call :meth:`fresh` so every run starts from the construction
    base, as in the reference (one ``secure_infer`` per Parties).

    A mesh rank holds two keys (:func:`party_keys`).  It runs every
    party's expressions, as the reference's one SPMD program does, and
    keeps only its own; a draw from the key it lacks is zeros, so a value
    it holds or opens that depended on that key would differ from the
    local run's."""

    keys: list  # three prf.Key
    _cnt: int = 0
    device: torch.device | str = "cpu"

    def __post_init__(self):
        self.keys = [None if k is None else tuple(int(w) for w in k)
                     for k in self.keys]
        self._base = self._cnt

    @classmethod
    def setup(cls, session_key: prf.Key, device="cpu") -> "Parties":
        return cls(prf.split(session_key, PARTIES), device=device)

    def fresh(self) -> "Parties":
        return Parties(self.keys, self._base, self.device)

    def _next(self) -> int:
        self._cnt += 1
        return self._cnt

    def _stream(self, pairs, shape, ring: RingSpec | None = None,
                bits: bool = False) -> torch.Tensor:
        """Stacked draws of ``fold_in(keys[i], cnt)`` over the ``(i, cnt)``
        ``pairs``, one batched evaluation: ring words of ``ring`` (default
        RING32), or with ``bits`` uint8 words; zeros for an absent key."""
        held = [j for j, (i, _) in enumerate(pairs)
                if self.keys[i] is not None]
        if len(held) < len(pairs):
            out = torch.zeros(
                (len(pairs),) + tuple(int(d) for d in shape),
                dtype=torch.uint8 if bits else (ring or default_ring()).dtype,
                device=self.device)
            if held:
                out[held] = self._stream([pairs[j] for j in held], shape,
                                         ring, bits)
            return out
        ks = [prf.fold_in(self.keys[i], c) for i, c in pairs]
        if bits:
            return prf.bits_multi(ks, shape, torch.uint8, self.device)
        return prf.ring_bits(ks, shape, (ring or default_ring()).bits,
                             device=self.device)

    # -- 3-out-of-3: additive sharing of zero ----------------------------
    def zero_shares(self, shape, ring: RingSpec | None = None):
        cnt = self._next()
        t = transport.current()
        f, fn = t.prf_parts_pair(
            range(PARTIES),
            lambda idx: self._stream([(i, cnt) for i in idx], shape, ring))
        return fn - f

    # -- 2-out-of-3: RSS of a fresh random value --------------------------
    def rand_rss(self, shape, ring: RingSpec | None = None,
                 max_bits: int | None = None) -> RSS:
        """RSS of an unknown-to-all random a; with ``max_bits`` each share
        is < 2^{max_bits-2}, so a < 2^max_bits."""
        ring = ring or default_ring()
        cnt = self._next()

        def draw(idx):
            f = self._stream([(i, cnt) for i in idx], shape, ring)
            if max_bits is not None:
                f = f & ((1 << max(max_bits - 2, 1)) - 1)
            return f

        return RSS(transport.current().prf_rss(range(PARTIES), draw), ring)

    def rand_rss_open(self, shape, ring: RingSpec | None = None):
        """(RSS of a random a, plaintext a): the simulation shortcut of
        the baselines that need the opened mask (``truncate_probabilistic``);
        every party's PRF stream is computed from the replicated keys."""
        if None in self.keys:
            raise ValueError("rand_rss_open opens the mask from all three "
                             "keys: a simulation shortcut, not a party's")
        ring = ring or default_ring()
        cnt = self._next()
        fs = self._stream([(i, cnt) for i in range(PARTIES)], shape, ring)
        r = RSS(transport.current().build_rss(list(fs)), ring)
        return r, fs[0] + fs[1] + fs[2]

    def rand_bits(self, shape) -> BinRSS:
        """2-of-3 XOR sharing of a fresh random bit tensor."""
        cnt = self._next()

        def draw(idx):
            return self._stream([(i, cnt) for i in idx], shape,
                                bits=True) & 1

        return BinRSS(transport.current().prf_rss(range(PARTIES), draw))

    # -- pairwise common randomness ---------------------------------------
    def common_pair(self, a: int, b: int, shape,
                    ring: RingSpec | None = None):
        """Random tensor known to parties a and b only (key k_{i+1} is
        common to the pair {i, i+1})."""
        if (a + 1) % PARTIES == b:
            kidx = b
        elif (b + 1) % PARTIES == a:
            kidx = a
        else:
            raise ValueError(f"no common key for pair ({a},{b})")
        return self._stream([(kidx, self._next())], shape, ring)[0]

    def private_to(self, i: int, shape, ring: RingSpec | None = None):
        """Random tensor private to P_i (from both of its keys)."""
        cnt = self._next()
        f = self._stream([(i, cnt), ((i + 1) % PARTIES, cnt)], shape, ring)
        return f[0] + f[1]

    # -- protocol material -------------------------------------------------
    def ot_masks(self, kidx: int, shape, ring: RingSpec | None = None):
        """(mask0, mask1) of one 3-party OT: one counter tick, the second
        mask at a fixed offset so the two streams never collide."""
        cnt = self._next()
        m = self._stream([(kidx, cnt), (kidx, cnt + 100003)], shape, ring)
        return m[0], m[1]

    def msb_material(self, shape, ring: RingSpec, r_bits: int,
                     tag: str = "msb"):
        """Offline material of one MSB extraction (Alg 3):
        ``([β]^B, [β]^A, [ρ])`` with ρ = (−1)^β·r for a positive odd
        r < 2^{r_bits+1}, run inline under ``comm.preprocessing()``."""
        from . import comm
        from .linear import mul
        from .msb import b2a
        from .rss import public_rss

        with comm.preprocessing():
            beta = self.rand_bits(shape)
            beta_a = b2a(beta, self, ring, tag=tag + ".b2a")
            r = self.rand_rss(shape, ring, max_bits=r_bits)
            r = r.mul_public_int(2).add_public(1)
            one_minus_2b = (public_rss(1, shape, ring, self.device)
                            - beta_a.mul_public_int(2))
            rho = mul(one_minus_2b, r, self, tag=tag + ".rho")
        return beta, beta_a, rho
