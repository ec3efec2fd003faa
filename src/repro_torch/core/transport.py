"""Party transport: every inter-party data movement in one place.

Port of ``repro/core/transport.py::LocalTransport`` only: the stacked
single-program simulation, with shares on a leading axis of size 3, the
neighbour share ``x_{i+1}`` as a roll, and openings as stack sums.  The
communication is accounted (comm.py), never performed.  Each movement op
calls ``telemetry.movement`` (one attribute test with no registry
installed; per query with one) and pushes the digests of its message
views into the active integrity verifier (core/integrity.py; one
``integrity.active()`` test and no digest with none active).
``MeshTransport`` belongs to a later slice of the port.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from . import integrity, telemetry

__all__ = ["LocalTransport", "current", "use_transport", "PARTIES"]

PARTIES = 3


class LocalTransport:
    """Stacked-axis single-program simulation."""

    name = "local"
    # shares are globally stacked: the neighbour slot is a roll, not a
    # carried pair (what FaultInjectingTransport branches on)
    carries_pair = False

    @property
    def rss_slots(self) -> int:
        return PARTIES

    @property
    def parts_slots(self) -> int:
        return PARTIES

    # -- views -----------------------------------------------------------
    def own_view(self, stack):
        return stack

    def next_view(self, stack):
        """x_{i+1} aligned with x_i: the second half of P_i's pair."""
        return torch.roll(stack, -1, dims=0)

    def slot_view(self, stack, i: int):
        return stack[i]

    # -- movement --------------------------------------------------------
    def complete(self, parts):
        """Additive parts -> RSS stack (P_i sends z_i to P_{i-1}); the
        stacked simulation already holds every slot."""
        telemetry.movement("complete", self.name)
        v = integrity.active()
        if v is not None:
            own = integrity.fold_digest_rows(parts)
            v.observe_pair(own, torch.roll(own, -1, dims=0))
        return parts

    def send(self, x, frm: int, to: int):
        telemetry.movement("send", self.name)
        v = integrity.active()
        if v is not None:
            row = integrity.fold_digest(x).expand(PARTIES)
            v.observe_send(row, row, frm, to)
        return x

    def merge_recv(self, primary, received, holder: int):
        """A sender-side value with its received copy: one tensor here."""
        return primary

    # -- openings --------------------------------------------------------
    def open_parts(self, parts):
        """All parties learn the sum of the additive parts."""
        telemetry.movement("open_parts", self.name)
        return _observe_open(parts[0] + parts[1] + parts[2])

    def open_rss(self, stack):
        """Reveal a shared value (P_i sends x_i to P_{i-1})."""
        telemetry.movement("open_rss", self.name)
        return _observe_open(stack[0] + stack[1] + stack[2])

    # -- party-indexed construction --------------------------------------
    def build_rss(self, vals: Sequence):
        """RSS stack from per-slot values (vals[i] known to both holders
        of slot i)."""
        return torch.stack(list(vals))

    def build_parts(self, vals: Sequence):
        return torch.stack(list(vals))

    # -- PRF layout ------------------------------------------------------
    def prf_rss(self, keys, draw: Callable):
        """RSS stack of PRF draws, slot i = F(k_i).  ``draw`` takes the
        list of key indices and returns the stacked draws (one batched PRF
        evaluation instead of one per key)."""
        return draw(list(keys))

    def prf_parts_pair(self, keys, draw: Callable):
        """(F(k_i), F(k_{i+1})) in additive alignment (``keys``: the key
        indices, as in :meth:`prf_rss`)."""
        f = draw(list(keys))
        return f, torch.roll(f, -1, dims=0)


def _observe_open(o):
    """Every party's view of an honest opening is ``o``."""
    v = integrity.active()
    if v is not None:
        v.observe_open(integrity.fold_digest(o).expand(PARTIES))
    return o


_STACK: list = []
_DEFAULT = LocalTransport()


def current() -> LocalTransport:
    return _STACK[-1] if _STACK else _DEFAULT


@contextlib.contextmanager
def use_transport(t: LocalTransport):
    _STACK.append(t)
    try:
        yield t
    finally:
        _STACK.pop()
