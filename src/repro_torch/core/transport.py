"""Party transport: every inter-party data movement in one place.

Port of ``repro/core/transport.py``.  Two backends:

``LocalTransport`` (default)
    The stacked single-program simulation: shares on a leading axis of
    size 3, the neighbour share ``x_{i+1}`` a roll, openings stack sums.
    The communication is accounted (comm.py), never performed.

``MeshTransport``
    One party's program in one process of a three-rank gloo group
    (core/party_group.py; the reference runs it inside ``shard_map`` over
    a size-3 mesh axis).  Share stacks are carried as the replicated pair
    ``[x_i, x_{i+1}]`` (leading axis 2), additive parts as ``[z_i]``
    (leading axis 1).  ``complete`` and ``open_rss`` are one ring exchange
    (P_i sends to P_{i-1}, receives from P_{i+1}), ``open_parts`` an
    all-gather, ``send`` a point-to-point message.  Gloo moves CPU tensors
    only: CUDA tensors are staged through pinned host buffers, and that
    time is kept apart in the :class:`WireCounter`, which also counts the
    messages and bytes this rank sends, by op and by ledger tag.  Summed
    over the three ranks the bytes follow the reference's wire convention
    (``roofline/analyze.py::party_wire_bytes_from_hlo``): a point-to-point
    pair counts its operand once, an all-gather of D members operand ×
    D × (D − 1).

Layouts (leading axis = party):

  =============  ===============  ===========================
  layout         LocalTransport   MeshTransport (per rank)
  =============  ===============  ===========================
  RSS stack      (3, *s) x_i      (2, *s)  [x_i, x_{i+1}]
  additive parts (3, *s) z_i      (1, *s)  [z_i]
  plain value    (*s) global      (*s) valid on its holders
  =============  ===============  ===========================

Each movement op calls ``telemetry.movement`` (one attribute test with no
registry installed; per query with one) and pushes the digests of its
message views into the active integrity verifier (core/integrity.py; one
``integrity.active()`` test and no digest with none active).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Sequence

import torch

from . import integrity, telemetry

__all__ = ["LocalTransport", "MeshTransport", "WireCounter", "current",
           "use_transport", "PARTIES"]

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

    def ingest(self, own, nxt):
        """An RSS stack from pre-paired inputs (``nxt`` unused: the stack
        already carries every party's share)."""
        return own

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

    def party_mask_rss(self, i: int, ndim: int, dtype, device=None):
        """{0, 1} mask selecting share slot i of an RSS stack."""
        m = torch.zeros((PARTIES,) + (1,) * ndim, dtype=dtype, device=device)
        m[i] = 1
        return m

    def party_mask_parts(self, i: int, ndim: int, dtype, device=None):
        return self.party_mask_rss(i, ndim, dtype, device)

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


class WireCounter:
    """What one rank put on the wire: messages and bytes it sent, by op
    and by ledger tag (the tag of the last ``comm.record``, ``pre:``
    prefixed for offline rows, as the ledger keys them; feed it with
    ``comm.listening(counter.listen)``), and the seconds spent staging
    CUDA tensors through host buffers."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.messages = 0
        self.nbytes = 0
        self.by_op = collections.defaultdict(lambda: [0, 0])
        self.by_tag = collections.defaultdict(lambda: [0, 0])
        self.staging_s = 0.0
        self._tag = None

    def listen(self, tag, rounds, nbytes, preprocess):
        self._tag = "pre:" + tag if preprocess else tag

    def sent(self, op: str, nbytes: int, messages: int = 1):
        self.messages += messages
        self.nbytes += nbytes
        for d, k in ((self.by_op, op), (self.by_tag, self._tag)):
            d[k][0] += messages
            d[k][1] += nbytes

    def summary(self) -> dict:
        """Plain-dict copy (picklable: what a rank sends back)."""
        return {"messages": self.messages, "nbytes": self.nbytes,
                "staging_s": self.staging_s,
                "by_op": {k: list(v) for k, v in self.by_op.items()},
                "by_tag": {k: list(v) for k, v in self.by_tag.items()}}


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class MeshTransport:
    """One party's program in a three-rank gloo group (rank = ``pid``).

    Valid only inside a rank of a :class:`~.party_group.PartyGroup` (or any
    initialised three-rank ``torch.distributed`` group).  Every movement is
    a real message: the ring exchange of ``complete`` / ``open_rss``
    (``batch_isend_irecv``), the all-gather of ``open_parts``, the
    point-to-point ``send``.  The party id is a Python int here, so the
    reference's ``where(pid == i, ...)`` selections are plain branches."""

    name = "mesh"
    carries_pair = True

    def __init__(self, pid: int, wire: WireCounter | None = None):
        if pid not in range(PARTIES):
            raise ValueError(f"party id {pid} is not in 0..{PARTIES - 1}")
        self.pid = pid
        self.wire = wire if wire is not None else WireCounter()

    # -- the wire ----------------------------------------------------------
    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        """A CPU copy of ``x`` for gloo (pinned, timed, for a CUDA tensor)."""
        x = x.contiguous()
        if x.device.type != "cuda":
            return x
        t0 = time.perf_counter()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        self.wire.staging_s += time.perf_counter() - t0
        return buf

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype,
                           pin_memory=like.device.type == "cuda")

    def _land(self, buf: torch.Tensor, device) -> torch.Tensor:
        if torch.device(device).type != "cuda":
            return buf
        t0 = time.perf_counter()
        out = buf.to(device)
        self.wire.staging_s += time.perf_counter() - t0
        return out

    def _recv_from_next(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """On party i: x from party i+1 (each P_i sends x to P_{i-1})."""
        import torch.distributed as dist
        out = self._stage(x)
        buf = self._buffer(out)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, (self.pid - 1) % PARTIES),
            dist.P2POp(dist.irecv, buf, (self.pid + 1) % PARTIES)])
        for r in reqs:
            r.wait()
        self.wire.sent(op, _nbytes(out))
        return self._land(buf, x.device)

    # -- layout ------------------------------------------------------------
    @property
    def rss_slots(self) -> int:
        return 2

    @property
    def parts_slots(self) -> int:
        return 1

    def ingest(self, own, nxt):
        return torch.cat([own, nxt])

    # -- views -------------------------------------------------------------
    def own_view(self, stack):
        return stack[0:1]

    def next_view(self, stack):
        return stack[1:2]

    def slot_view(self, stack, i: int):
        """Absolute slot i: valid on its holders, P_i (own) and P_{i-1}
        (the neighbour copy); the third party reads its second slot, as
        in the reference."""
        return stack[0] if self.pid == i else stack[1]

    # -- movement ----------------------------------------------------------
    def complete(self, parts):
        telemetry.movement("complete", self.name)
        recv = self._recv_from_next(parts, "complete")
        v = integrity.active()
        if v is not None:
            v.observe_pair(integrity.fold_digest(parts[0]),
                           integrity.fold_digest(recv[0]))
        return torch.cat([parts, recv])

    def _p2p(self, x: torch.Tensor, frm: int, to: int) -> torch.Tensor:
        """P_frm -> P_to; every party but ``to`` gets zeros (the
        reference's single-pair ``ppermute``)."""
        import torch.distributed as dist
        if self.pid == frm:
            out = self._stage(x)
            dist.send(out, to)
            self.wire.sent("send", _nbytes(out))
        elif self.pid == to:
            buf = self._buffer(x)
            dist.recv(buf, frm)
            return self._land(buf, x.device)
        return torch.zeros_like(x)

    def send(self, x, frm: int, to: int):
        telemetry.movement("send", self.name)
        r = self._p2p(x, frm, to)
        v = integrity.active()
        if v is not None:
            v.observe_send(integrity.fold_digest(x), integrity.fold_digest(r),
                           frm, to)
        return r

    def merge_recv(self, primary, received, holder: int):
        return received if self.pid == holder else primary

    # -- openings ----------------------------------------------------------
    def _gather(self, part: torch.Tensor) -> list:
        import torch.distributed as dist
        out = self._stage(part)
        bufs = [self._buffer(out) for _ in range(PARTIES)]
        dist.all_gather(bufs, out)
        self.wire.sent("open_parts", (PARTIES - 1) * _nbytes(out),
                       PARTIES - 1)
        return [self._land(b, part.device) for b in bufs]

    def open_parts(self, parts):
        telemetry.movement("open_parts", self.name)
        g = self._gather(parts[0])
        return self._observe(g[0] + g[1] + g[2])

    def open_rss(self, stack):
        """P_i holds (x_i, x_{i+1}); the missing x_{i+2} is P_{i+1}'s
        second component: one ring exchange, the ledger's 3 messages."""
        telemetry.movement("open_rss", self.name)
        third = self._recv_from_next(stack[1], "open_rss")
        return self._observe(stack[0] + stack[1] + third)

    def _observe(self, o):
        v = integrity.active()
        if v is not None:
            v.observe_open(integrity.fold_digest(o))
        return o

    # -- party-indexed construction ----------------------------------------
    def build_rss(self, vals: Sequence):
        return torch.stack([vals[self.pid], vals[(self.pid + 1) % PARTIES]])

    def build_parts(self, vals: Sequence):
        return vals[self.pid][None]

    def party_mask_rss(self, i: int, ndim: int, dtype, device=None):
        m = torch.tensor([self.pid == i, self.pid == (i - 1) % PARTIES],
                         dtype=dtype, device=device)
        return m.reshape((2,) + (1,) * ndim)

    def party_mask_parts(self, i: int, ndim: int, dtype, device=None):
        return torch.tensor([self.pid == i], dtype=dtype,
                            device=device).reshape((1,) + (1,) * ndim)

    # -- PRF layout --------------------------------------------------------
    def prf_rss(self, keys, draw: Callable):
        """P_i's pair of PRF draws: (F(k_i), F(k_{i+1})), one batched
        evaluation (equal shapes give the local run's exact words)."""
        keys = list(keys)
        return draw([keys[self.pid], keys[(self.pid + 1) % PARTIES]])

    def prf_parts_pair(self, keys, draw: Callable):
        f = self.prf_rss(keys, draw)
        return f[0:1], f[1:2]


_STACK: list = []
_DEFAULT = LocalTransport()


def current() -> LocalTransport | MeshTransport:
    return _STACK[-1] if _STACK else _DEFAULT


@contextlib.contextmanager
def use_transport(t):
    _STACK.append(t)
    try:
        yield t
    finally:
        _STACK.pop()
