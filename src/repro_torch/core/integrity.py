"""Integrity layer of the 3-party runtime (DESIGN.md §14).

Port of ``repro/core/integrity.py``: the typed failures
(:class:`IntegrityError`, :class:`MaterialDesyncError`,
:class:`PoolExhaustedError`), :func:`fold_digest`, the deferred
compare-view :class:`Verifier` in ``opens`` / ``full`` mode with
:func:`verify_scope` / :func:`active`, the fault-injection harness
(:class:`Fault`, :class:`FaultInjectingTransport`) and the ingest checks
(:func:`verify_tape_slice`, :func:`verify_model_ingest`).  The harness
has the reference's two branches: the stacked ``LocalTransport`` one and
the carried-pair one, where it wraps one rank's ``MeshTransport`` and
only the victim rank's received view is tampered.  Under the mesh each
rank records 0-d digests, its report is one (n,) row per key, and the
caller stacks the three ranks' rows to (3, n) before :meth:`Verifier.check`.

The reference records digests while jax traces one program; the port
runs eagerly, so a "trace" is one query: :func:`verify_scope` calls
:meth:`Verifier.begin` per query, the transports push a digest per
movement op (one int32 tensor on the query's device, the uint32 bits of
the reference's), :meth:`Verifier.traced_report` stacks that query's
digests, and :meth:`Verifier.check` copies the whole report to the host
in one transfer per query.  With no verifier active a movement op pays
one :func:`active` test and computes no digest.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import comm

__all__ = ["IntegrityError", "MaterialDesyncError", "PoolExhaustedError",
           "Verifier", "VERIFY_MODES", "REPORT_KEYS", "fold_digest",
           "verify_scope", "active", "FaultInjectingTransport", "Fault",
           "verify_tape_slice", "verify_model_ingest"]

PARTIES = 3

VERIFY_MODES = ("off", "opens", "full")

# report keys: always all present, as in the reference
REPORT_KEYS = ("open", "pair_own", "pair_recv", "send_own", "send_recv")

_MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1 - (1 << 32)   # the reference's uint32 weight, signed


class IntegrityError(RuntimeError):
    """A party deviation / runtime corruption the integrity layer caught.

    Attributes (``None`` when not applicable): ``tag`` (the protocol op
    path label active when the message moved), ``op`` (``open`` /
    ``reshare`` / ``send``, or ``ingest``), ``index`` (0-based per-kind op
    counter within the query), ``round`` (the ledger's cumulative round
    index at the op), ``party`` (the receiver whose view diverged)."""

    def __init__(self, msg, *, tag=None, op=None, index=None, round=None,
                 party=None):
        super().__init__(msg)
        self.tag = tag
        self.op = op
        self.index = index
        self.round = round
        self.party = party


class MaterialDesyncError(IntegrityError):
    """Tape material does not match the traced MaterialSpec (draw order,
    shape, ring or slab layout): the online phase aborts instead of
    consuming it."""


class PoolExhaustedError(IntegrityError):
    """The tape pool ran out of material for the demanded queries: refusing
    to serve beats replaying consumed correlated randomness."""


# ---------------------------------------------------------------------------
# Digests
# ---------------------------------------------------------------------------

def _words32(x: torch.Tensor) -> torch.Tensor:
    """(rows, n) int32 words of a (rows, ...) message stack: uint8 bit
    shares zero-extend; 64-bit words fold ``v ^ (v >>> 32)`` (a logical
    shift, as the reference's uint64) and keep the low 32 bits."""
    v = x.reshape(x.shape[0], -1)
    if v.dtype.itemsize == 8:
        v = v ^ ((v >> 32) & _MASK32)
        v = ((v & _MASK32) ^ (1 << 31)) - (1 << 31)
    return v.to(torch.int32)


def _fold(v: torch.Tensor) -> torch.Tensor:
    """Row-wise position-weighted fold of (rows, n) int32 words mod 2^32."""
    n = v.shape[1]
    w = ((torch.arange(n, dtype=torch.int32, device=v.device) << 1) | 1) \
        * _GOLDEN
    s = torch.sum(v * w, dim=1)          # int64: exact, then wrap
    return (((s & _MASK32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def fold_digest(x: torch.Tensor) -> torch.Tensor:
    """Position-weighted uint32 fold of a message tensor (the reference's
    ``fold_digest``), as a 0-d int32 tensor holding the same 32 bits."""
    return _fold(_words32(x.reshape(1, -1)))[0]


def fold_digest_rows(stack: torch.Tensor) -> torch.Tensor:
    """``[fold_digest(stack[i]) for i]`` as one (rows,) tensor: every row
    has the same length, so they share the weights."""
    return _fold(_words32(stack))


def as_uint32(d) -> np.ndarray:
    """Digests (int32 tensors or arrays) as the reference's uint32."""
    if isinstance(d, torch.Tensor):
        d = d.cpu().numpy()
    return np.asarray(d).astype(np.int64).astype(np.uint32)


# ---------------------------------------------------------------------------
# The verifier
# ---------------------------------------------------------------------------

class Verifier:
    """Deferred compare-view verification of one secure query.

    Transports push per-op digest entries via ``observe_*`` while a
    :func:`verify_scope` is active (each entry a ``(3,)`` row: all
    parties' views are in the stacked program); :meth:`traced_report`
    stacks them into the report; :meth:`check` compares the per-party
    digest columns on the host and raises :class:`IntegrityError` on the
    earliest diverging op.  :meth:`begin` (called by ``verify_scope`` on
    every query) resets the op metadata."""

    def __init__(self, mode: str = "full"):
        if mode not in VERIFY_MODES:
            raise ValueError(f"verify mode {mode!r} is not one of "
                             f"{VERIFY_MODES}")
        self.mode = mode
        self.begin()

    # -- recording ---------------------------------------------------------
    def begin(self):
        self.rows = {k: [] for k in REPORT_KEYS}
        self.meta = []          # one dict per verified op, in run order
        self._tag = None        # updated by the comm.record listener
        self._rounds = 0

    def _listen(self, tag, rounds, nbytes, preprocess):
        self._tag = tag
        self._rounds += rounds

    def _note(self, kind, entries, **info):
        idx = len(self.rows[next(iter(entries))])
        self.meta.append(dict(kind=kind, idx=idx, tag=self._tag,
                              round=self._rounds, **info))
        for key, e in entries.items():
            self.rows[key].append(e)

    def observe_open(self, digest):
        """One opening (open_parts / open_rss): (3,) per-party digests of
        the opened value."""
        if self.mode != "off":
            self._note("open", {"open": digest})

    def observe_pair(self, own, recv):
        """One reshare: digests of the part each party computed (``own``)
        and of the copy it received (``recv``).  Honest iff
        ``recv[i] == own[(i+1) % 3]``."""
        if self.mode == "full":
            self._note("reshare", {"pair_own": own, "pair_recv": recv})

    def observe_send(self, own, recv, frm: int, to: int):
        """One point-to-point send: the sent value's digest at ``frm`` vs
        the received value's at ``to``."""
        if self.mode == "full":
            self._note("send", {"send_own": own, "send_recv": recv},
                       frm=frm, to=to)

    def traced_report(self) -> dict:
        """The query's per-party digest report ({key: (3, n) int32}),
        recorded on the ledger as the ONE extra compare-view round."""
        n_ops = len(self.meta)
        comm.record("verify.digest", rounds=1 if n_ops else 0,
                    nbytes=PARTIES * sum(len(v) for v in self.rows.values())
                    * 4)
        from . import transport
        dev = next((v[0].device for v in self.rows.values() if v), "cpu")
        empty = (0,) if transport.current().carries_pair else (PARTIES, 0)
        return {k: (torch.stack(v, dim=-1) if v
                    else torch.zeros(empty, dtype=torch.int32, device=dev))
                for k, v in self.rows.items()}

    # -- host-side check ---------------------------------------------------
    def check(self, report: dict):
        """Raise :class:`IntegrityError` for the earliest diverging op in
        ``report`` (one device-to-host copy of the whole report)."""
        if self.mode == "off":
            return
        from . import telemetry
        with telemetry.span("verify.check", cat="verify", mode=self.mode,
                            ops=len(self.meta)):
            try:
                self._check(report)
            except IntegrityError as e:
                telemetry.inc("integrity_aborts_total", op=e.op or "?")
                raise

    def _check(self, report: dict):
        widths = [int(report[k].shape[-1]) for k in REPORT_KEYS]
        host = as_uint32(torch.cat([report[k].reshape(PARTIES, -1)
                                    for k in REPORT_KEYS], dim=1))
        rep, at = {}, 0
        for k, w in zip(REPORT_KEYS, widths):
            rep[k] = host[:, at:at + w]
            at += w
        for m in self.meta:
            kind, idx = m["kind"], m["idx"]
            if kind == "open":
                col = rep["open"][:, idx]
                if col[0] == col[1] == col[2]:
                    continue
                party = next((p for p in range(PARTIES)
                              if col[(p + 1) % 3] == col[(p + 2) % 3]
                              and col[p] != col[(p + 1) % 3]), None)
                self._raise(m, party,
                            f"opened views diverge across parties "
                            f"(digests {[hex(int(c)) for c in col]})")
            elif kind == "reshare":
                own, recv = rep["pair_own"][:, idx], rep["pair_recv"][:, idx]
                for i in range(PARTIES):
                    if recv[i] != own[(i + 1) % 3]:
                        self._raise(
                            m, i,
                            f"reshare pair inconsistent: P{i} received "
                            f"{hex(int(recv[i]))}, P{(i + 1) % 3} computed "
                            f"{hex(int(own[(i + 1) % 3]))}")
            else:  # send
                frm, to = m["frm"], m["to"]
                own, recv = rep["send_own"][:, idx], rep["send_recv"][:, idx]
                if recv[to] != own[frm]:
                    self._raise(
                        m, to,
                        f"send P{frm}->P{to} tampered: sent "
                        f"{hex(int(own[frm]))}, received "
                        f"{hex(int(recv[to]))}")

    def _raise(self, m, party, detail):
        raise IntegrityError(
            f"integrity violation in {m['kind']} #{m['idx']} "
            f"(op {m['tag']!r}, round {m['round']}, party "
            f"{'?' if party is None else party}): {detail} — aborting "
            f"before releasing an output",
            tag=m["tag"], op=m["kind"], index=m["idx"], round=m["round"],
            party=party)


_ACTIVE: list[Verifier] = []


def active() -> Verifier | None:
    """The verifier the transports push digests into, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def verify_scope(v: Verifier | None):
    """Activate ``v`` for the enclosed query (no-op for ``None`` / off)."""
    if v is None or v.mode == "off":
        yield None
        return
    v.begin()
    _ACTIVE.append(v)
    comm.add_listener(v._listen)
    try:
        yield v
    finally:
        comm.remove_listener(v._listen)
        _ACTIVE.pop()


# ---------------------------------------------------------------------------
# Fault injection: the chaos harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Fault:
    """One deterministic fault: corrupt the message *received* by
    ``party`` in the ``index``-th movement op of kind ``op``.

    op:    "open" (open_parts + open_rss share one counter), "reshare"
           (transport.complete) or "send" (point-to-point).
    mode:  "corrupt" (bit flip: ^1 on bit shares, ^(1<<16) on ring
           words), "zero", "replay" (the previous same-kind message, zeros
           when shapes differ), "drop" (modelled as zero-fill: the
           receiver times out and substitutes zeros).
    party: receiving party slot; for "send", ``None`` targets the op's
           natural receiver."""

    op: str
    index: int
    mode: str
    party: int | None = None

    def __post_init__(self):
        if self.op not in ("open", "reshare", "send"):
            raise ValueError(f"fault op {self.op!r}")
        if self.mode not in ("corrupt", "zero", "replay", "drop"):
            raise ValueError(f"fault mode {self.mode!r}")
        if self.party is None and self.op != "send":
            raise ValueError("open/reshare faults must name the receiving "
                             "party")


class FaultInjectingTransport:
    """Transport wrapper injecting configured :class:`Fault` s over the
    stacked ``LocalTransport`` or one rank's ``MeshTransport``.

    Reimplements the four movement ops (never delegating movement to the
    base's observed ops, so honest digests are not observed twice);
    everything else forwards to the base.  Stacked, the program follows
    the victim's view, so an unverified run returns what the victim would
    compute; under the mesh only the victim rank's received message is
    tampered and every rank follows its own view.  Either way the
    verifier's digests see the other parties' honest views, so ``check``
    names the configured receiving party.  The op counters run from
    construction (or :meth:`fresh`) on, across queries."""

    def __init__(self, base, faults):
        self.base = base
        self.faults = [f if isinstance(f, Fault) else Fault(**f)
                       for f in faults]
        self.fresh()

    def fresh(self):
        self._counts = {"open": 0, "reshare": 0, "send": 0}
        self._stale = {}   # op kind -> previous honest message (replay)
        self.fired = []    # (op, index, Fault) actually injected
        return self

    def __getattr__(self, name):
        return getattr(self.base, name)

    # -- fault plumbing ------------------------------------------------------
    def _match(self, op: str) -> Fault | None:
        k = self._counts[op]
        self._counts[op] += 1
        for f in self.faults:
            if f.op == op and f.index == k:
                return f
        return None

    def _tamper(self, f: Fault, honest, op: str):
        """The corrupted message replacing ``honest``."""
        if f.mode in ("zero", "drop"):
            bad = torch.zeros_like(honest)
        elif f.mode == "corrupt":
            flip = 1 if honest.dtype == torch.uint8 else (1 << 16)
            bad = honest ^ flip
        else:  # replay
            prev = self._stale.get(op)
            bad = (prev if prev is not None and prev.shape == honest.shape
                   and prev.dtype == honest.dtype
                   else torch.zeros_like(honest))
        self.fired.append((op, self._counts[op] - 1, f))
        return bad

    # -- movement ops --------------------------------------------------------
    def complete(self, parts):
        f = self._match("reshare")
        v = active()
        if self.base.carries_pair:
            recv = honest = self.base._recv_from_next(parts, "complete")
            if f is not None:
                bad = self._tamper(f, recv, "reshare")
                if self.base.pid == f.party:
                    recv = bad
            self._stale["reshare"] = honest
            if v is not None:
                v.observe_pair(fold_digest(parts[0]), fold_digest(recv[0]))
            return torch.cat([parts, recv])
        recv_msgs = [parts[(i + 1) % PARTIES] for i in range(PARTIES)]
        out = parts
        if f is not None:
            t = f.party
            bad = self._tamper(f, recv_msgs[t], "reshare")
            recv_msgs[t] = bad
            # the victim's received copy is what downstream compute uses
            out = parts.clone()
            out[(t + 1) % PARTIES] = bad
        self._stale["reshare"] = parts[0]
        if v is not None:
            v.observe_pair(fold_digest_rows(parts),
                           fold_digest_rows(torch.stack(recv_msgs)))
        return out

    def open_parts(self, parts):
        return self._open(parts, "parts")

    def open_rss(self, stack):
        return self._open(stack, "rss")

    def _open(self, shares, which: str):
        f = self._match("open")
        if self.base.carries_pair:
            return self._open_pair(shares, which, f)
        o = shares[0] + shares[1] + shares[2]
        views = [o] * PARTIES
        if f is not None:
            t = f.party
            # open_parts: the part P_t receives from its successor;
            # open_rss: P_{t+1} forwards the missing share x_{t+2}
            src = (t + 2) % PARTIES if which == "rss" else (t + 1) % PARTIES
            honest = shares[src]
            bad = self._tamper(f, honest, "open")
            views[t] = o - honest + bad
        self._stale["open"] = shares[0]
        v = active()
        if v is not None:
            v.observe_open(fold_digest_rows(torch.stack(views)))
        # the program follows the victim's trajectory
        return views[f.party] if f is not None else o

    def _open_pair(self, shares, which: str, f: Fault | None):
        """The carried-pair opening: the victim's copy of the message it
        received (open_parts: the part from its successor; open_rss: the
        missing share x_{i+2}) is tampered on the victim rank only."""
        if which == "parts":
            g = self.base._gather(shares[0])
            o = g[0] + g[1] + g[2]
            stale = g[0]
        else:
            stale = self.base._recv_from_next(shares[1], "open_rss")
            o = shares[0] + shares[1] + stale
        if f is not None:
            honest = g[(f.party + 1) % PARTIES] if which == "parts" else stale
            bad = self._tamper(f, honest, "open")
            if self.base.pid == f.party:
                o = o - honest + bad
        self._stale["open"] = stale
        v = active()
        if v is not None:
            v.observe_open(fold_digest(o))
        return o

    def send(self, x, frm: int, to: int):
        f = self._match("send")
        live = f is not None and f.party in (None, to)
        if self.base.carries_pair:
            r = self.base._p2p(x, frm, to)
            if live:
                bad = self._tamper(f, r, "send")
                if self.base.pid == to:
                    r = bad
            self._stale["send"] = x
            v = active()
            if v is not None:
                v.observe_send(fold_digest(x), fold_digest(r), frm, to)
            return r
        out = x
        if live:
            out = self._tamper(f, x, "send")
        self._stale["send"] = x
        v = active()
        if v is not None:
            d_own = fold_digest(x)
            row = d_own.expand(PARTIES)
            recv = row.clone()
            if live:
                recv[to] = fold_digest(out)
            v.observe_send(row, recv, frm, to)
        return out


# ---------------------------------------------------------------------------
# Ingest-time consistency checks (host-side metadata)
# ---------------------------------------------------------------------------

def verify_tape_slice(spec, slabs: dict) -> None:
    """Structural check of one query's tape slabs against the traced
    MaterialSpec before the online phase consumes them: every slab
    present, right per-query shape, right dtype.  Raises
    :class:`MaterialDesyncError` (metadata only, no device sync)."""
    want = spec.slab_structs()
    for k, st in want.items():
        arr = slabs.get(k)
        if arr is None:
            raise MaterialDesyncError(
                f"material tape desync: slab {k!r} missing from the tape "
                f"(expected {tuple(st.shape)} {st.dtype})")
        if tuple(arr.shape) != tuple(st.shape) or arr.dtype != st.dtype:
            raise MaterialDesyncError(
                f"material tape desync: slab {k!r} is {tuple(arr.shape)} "
                f"{arr.dtype}, traced spec wants {tuple(st.shape)} "
                f"{st.dtype}")
    extra = set(slabs) - set(want)
    if extra:
        raise MaterialDesyncError(
            f"material tape desync: unexpected slabs {sorted(extra)!r}")


def verify_model_ingest(model) -> None:
    """RSS pair-consistency check on ingested model shares: every shared
    parameter stack carries the full 3-party replication (leading axis 3,
    the ring dtype).  Raises :class:`IntegrityError` naming the op index
    and entry."""
    from .rss import RSS, BinRSS
    for i, op in enumerate(model.ops):
        for key, val in op.items():
            stacks = val if isinstance(val, (list, tuple)) else [val]
            for j, s in enumerate(stacks):
                if not isinstance(s, (RSS, BinRSS)):
                    continue
                sh = tuple(int(d) for d in s.shares.shape)
                if sh[0] != PARTIES:
                    raise IntegrityError(
                        f"model ingest: op {i} ({op['op']}) entry "
                        f"{key!r}[{j}] share stack has leading axis "
                        f"{sh[0]}, expected {PARTIES}-party replication",
                        tag=f"l{i}.{key}", op="ingest", index=i)
                if isinstance(s, RSS) and s.shares.dtype != model.ring.dtype:
                    raise IntegrityError(
                        f"model ingest: op {i} ({op['op']}) entry "
                        f"{key!r}[{j}] dtype {s.shares.dtype} does not "
                        f"match the model ring {model.ring.dtype}",
                        tag=f"l{i}.{key}", op="ingest", index=i)
