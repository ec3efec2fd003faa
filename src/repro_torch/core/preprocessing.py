"""Offline preprocessing plant (DESIGN.md §12): traced material specs,
consumable tapes and an online-only serving phase.

Port of ``repro/core/preprocessing.py`` (``MaterialItem``, ``SlabInfo``,
``MaterialSpec``, ``trace_material``, ``make_tape_generator``,
``tape_session_keys``, ``MaterialTape``, ``generate_tape``,
``TapeParties``, ``TapePool``, ``make_tape_infer``, ``online_cost``) on
the stacked ``LocalTransport`` layout.  CBNN's protocols consume
input-independent correlated randomness (PRF zero shares, bounded
truncation pads, the MSB material with its B2A and ρ mult, OT masks);
the inline runtime draws it inside the online query, the plant ahead of
traffic:

  1. :func:`trace_material` runs one query of a compiled model on
     ``meta`` tensors with a recording ``Parties`` and returns the
     per-query :class:`MaterialSpec`: the ordered (kind, counter, shape,
     ring, aux) of every draw.  Nothing is computed.
  2. :func:`make_tape_generator` produces a :class:`MaterialTape` for N
     queries: per-kind slabs stacked ``(3, N, n_slots, *shape)``
     (party-stacked) or ``(N, n_slots, *shape)`` (key-replicated).  It
     runs the inline draw code itself, seeking the counter to each item's
     traced value, so playback equals inline draws bit for bit, and it
     equals the reference's tape for the same keys.  The port is eager:
     the generator is a host loop over the items that enqueues its work
     on the device's stream, each item drawn for all N queries in one
     PRF evaluation (the reference maps its plant over the queries).
  3. :class:`TapeParties` is the consumable: a ``Parties`` whose draw
     methods return the next tape slice instead of evaluating the PRF,
     so a tape-backed query runs no threefry at all and records only the
     ledger's online rows.

``TapeParties`` and the spec recorder override ``fresh()`` to reset in
place and return ``self``: ``secure_infer`` calls ``parties.fresh()``
first, and the base class returns a new inline ``Parties``, which would
quietly draw the PRF again (with bit-identical results, since tape ==
inline; only a count of PRF evaluations shows it).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from collections import Counter

import torch

from . import comm, integrity, prf, telemetry, transport
from .integrity import (MaterialDesyncError, PoolExhaustedError,
                        verify_tape_slice)
from .randomness import Parties
from .ring import RingSpec, default_ring
from .rss import RSS, BinRSS, PARTIES

__all__ = ["MaterialItem", "MaterialSpec", "MaterialTape", "TapeParties",
           "TapePool", "trace_material", "make_tape_generator",
           "generate_tape", "tape_session_keys", "online_cost",
           "make_tape_infer", "STACK_PAIR", "STACK_PARTS", "REPLICATED"]

# slab layout classes (how a party-sliced consumer reads the slab)
STACK_PAIR = "stack_pair"    # party-stacked; P_i consumes rows (i, i+1)
STACK_PARTS = "stack_parts"  # party-stacked; P_i consumes row i only
REPLICATED = "repl"          # derived from shared keys; held replicated

# kind -> list of (field suffix, layout, dtype kind): "ring" resolves to
# the item's ring dtype, "bits" to uint8
_KIND_FIELDS = {
    "zero": (("", STACK_PARTS, "ring"),),
    "rss": (("", STACK_PAIR, "ring"),),
    "bits": (("", STACK_PAIR, "bits"),),
    "pair": (("", REPLICATED, "ring"),),
    "private": (("", REPLICATED, "ring"),),
    "ot_masks": (("", REPLICATED, "ring"),),   # leading axis 2: (m0, m1)
    "msb": ((".beta", STACK_PAIR, "bits"),
            (".beta_a", STACK_PAIR, "ring"),
            (".rho", STACK_PAIR, "ring")),
}


def _field_dtype(dt: str, ring: RingSpec) -> torch.dtype:
    return torch.uint8 if dt == "bits" else ring.dtype


def _inner(item) -> tuple:
    return (2,) + item.shape if item.kind == "ot_masks" else item.shape


@dataclasses.dataclass(frozen=True)
class MaterialItem:
    """One correlated draw of the traced program, in consumption order.
    ``tag`` (the MSB material's ledger tag) labels the plant's offline
    ledger rows as the inline run labels them; it takes no part in
    equality or grouping."""

    kind: str          # key into _KIND_FIELDS
    cnt: int           # Parties counter value BEFORE the draw (seekable)
    shape: tuple       # tensor shape of the draw
    ring: RingSpec | None
    aux: tuple = ()    # (max_bits,) | (a, b) | (i,) | (kidx,) | (r_bits,)
    tag: str | None = dataclasses.field(default=None, compare=False)

    @property
    def group(self):
        return (self.kind, self.shape, self.ring, self.aux)


@dataclasses.dataclass(frozen=True)
class SlabInfo:
    layout: str        # STACK_PAIR | STACK_PARTS | REPLICATED
    shape: tuple       # per-query slab shape (party axis leading if stacked)
    dtype: torch.dtype


class MaterialSpec:
    """Ordered draw list and its grouping into stacked per-kind slabs.

    ``items[i]`` is consumed i-th; ``index[i] = (slab base key, slot)``
    locates it in the tape; ``slabs`` maps every full slab key (base +
    field suffix) to its :class:`SlabInfo`."""

    def __init__(self, items: list[MaterialItem]):
        self.items = list(items)
        self.index: list[tuple[str, int]] = []
        counts: dict[str, int] = {}
        base_of: dict = {}
        for it in self.items:
            g = it.group
            if g not in base_of:
                base_of[g] = f"g{len(base_of):02d}.{it.kind}"
                counts[base_of[g]] = 0
            base = base_of[g]
            self.index.append((base, counts[base]))
            counts[base] += 1
        self.slabs: dict[str, SlabInfo] = {}
        for g, base in base_of.items():
            kind, shape, ring, aux = g
            n = counts[base]
            inner = (2,) + shape if kind == "ot_masks" else shape
            for suffix, layout, dt in _KIND_FIELDS[kind]:
                sshape = ((n,) + inner if layout == REPLICATED
                          else (PARTIES, n) + inner)
                self.slabs[base + suffix] = SlabInfo(
                    layout, sshape, _field_dtype(dt, ring))
        self._gen: dict = {}    # device -> cached TapeGenerator

    def __len__(self):
        return len(self.items)

    def __getstate__(self):
        # the cached plants stay with their process (a party process gets
        # the spec alone)
        return {**self.__dict__, "_gen": {}}

    def slab_structs(self) -> dict:
        """Per-query slabs as ``meta`` tensors: shape and dtype only (what
        a shape-only run of the online program takes)."""
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in self.slabs.items()}

    @property
    def nbytes_per_query(self) -> int:
        return sum(math.prod(v.shape) * v.dtype.itemsize
                   for v in self.slabs.values())

    def summary(self) -> str:
        kinds = Counter(it.kind for it in self.items)
        els = sum(math.prod(v.shape) for v in self.slabs.values())
        return (f"{len(self.items)} draws ({dict(kinds)}), "
                f"{len(self.slabs)} slabs, {els:,} ring elements/query")


# ---------------------------------------------------------------------------
# Spec extraction: one shape-only query with a recording Parties
# ---------------------------------------------------------------------------

class _SpecParties(Parties):
    """Inline Parties that records every draw (kind, cnt, shape, aux)."""

    def __init__(self, keys, device="meta"):
        super().__init__(keys, device=device)
        self.items: list[MaterialItem] = []
        self._suspend = False   # True inside a composite (msb_material)

    def fresh(self):
        self._cnt = self._base
        return self

    def _rec(self, kind, shape, ring, aux=(), tag=None):
        if not self._suspend:
            self.items.append(MaterialItem(
                kind, self._cnt, tuple(int(d) for d in shape), ring, aux,
                tag))

    def zero_shares(self, shape, ring=None):
        ring = ring or default_ring()
        self._rec("zero", shape, ring)
        return super().zero_shares(shape, ring)

    def rand_rss(self, shape, ring=None, max_bits=None):
        ring = ring or default_ring()
        self._rec("rss", shape, ring, (max_bits,))
        return super().rand_rss(shape, ring, max_bits)

    def rand_bits(self, shape):
        self._rec("bits", shape, default_ring())
        return super().rand_bits(shape)

    def common_pair(self, a, b, shape, ring=None):
        ring = ring or default_ring()
        self._rec("pair", shape, ring, (a, b))
        return super().common_pair(a, b, shape, ring)

    def private_to(self, i, shape, ring=None):
        ring = ring or default_ring()
        self._rec("private", shape, ring, (i,))
        return super().private_to(i, shape, ring)

    def ot_masks(self, kidx, shape, ring=None):
        ring = ring or default_ring()
        self._rec("ot_masks", shape, ring, (kidx,))
        return super().ot_masks(kidx, shape, ring)

    def msb_material(self, shape, ring, r_bits, tag="msb"):
        self._rec("msb", shape, ring, (r_bits,), tag)
        self._suspend = True
        try:
            return super().msb_material(shape, ring, r_bits, tag)
        finally:
            self._suspend = False

    def rand_rss_open(self, shape, ring=None):
        raise NotImplementedError(
            "rand_rss_open (truncate_probabilistic baseline) is inline-only "
            "— the tape mode covers the serving protocol stack")


def trace_material(model, input_shape) -> MaterialSpec:
    """The per-query MaterialSpec of ``model`` at ``input_shape`` (batch
    included): one query on ``meta`` tensors under ``LocalTransport``,
    nothing computed."""
    from .secure_model import secure_infer
    rec = _SpecParties(prf.split(prf.PRNGKey(0), PARTIES))
    x = torch.empty((PARTIES,) + tuple(input_shape), dtype=model.ring.dtype)

    def run(m, xs):
        return secure_infer(m, RSS(xs, m.ring), rec)

    with transport.use_transport(transport.LocalTransport()):
        comm.estimate_cost(run, model, x)
    return MaterialSpec(rec.items)


# ---------------------------------------------------------------------------
# Offline generation: the material plant
# ---------------------------------------------------------------------------

def _draw_inline(p: Parties, item: MaterialItem) -> dict:
    """The inline draw of one item (counter already seeked) as {field
    suffix -> slab row}: the code the online path would have run."""
    if item.kind == "zero":
        return {"": p.zero_shares(item.shape, item.ring)}
    if item.kind == "rss":
        return {"": p.rand_rss(item.shape, item.ring,
                               max_bits=item.aux[0]).shares}
    if item.kind == "bits":
        return {"": p.rand_bits(item.shape).shares}
    if item.kind == "pair":
        return {"": p.common_pair(item.aux[0], item.aux[1], item.shape,
                                  item.ring)}
    if item.kind == "private":
        return {"": p.private_to(item.aux[0], item.shape, item.ring)}
    if item.kind == "ot_masks":
        m0, m1 = p.ot_masks(item.aux[0], item.shape, item.ring)
        return {"": torch.stack([m0, m1])}
    if item.kind == "msb":
        beta, beta_a, rho = p.msb_material(item.shape, item.ring,
                                           item.aux[0],
                                           tag=item.tag or "tape")
        return {".beta": beta.shares, ".beta_a": beta_a.shares,
                ".rho": rho.shares}
    raise ValueError(f"unknown material kind {item.kind!r}")


class _QueryBatch(Parties):
    """The plant's Parties over N queries' keys at once (the reference's
    ``vmap`` over queries): a draw of shape ``(N, *s)`` is, at ``[q]``,
    query q's draw of shape ``s`` under its own keys, from one PRF
    evaluation over all N queries' keys.  The protocol code between the
    draws (the MSB material's B2A and ρ mult) is elementwise, so it runs
    on the N queries together."""

    def __init__(self, keys_stack, device):
        super().__init__(keys_stack[0], device=device)
        self.keys_stack = [[tuple(int(w) for w in k) for k in keys]
                           for keys in keys_stack]

    def _stream(self, pairs, shape, ring=None, bits=False):
        n, inner = int(shape[0]), tuple(shape[1:])
        ks = [prf.fold_in(keys[i], c) for i, c in pairs
              for keys in self.keys_stack]
        if bits:
            out = prf.bits_multi(ks, inner, torch.uint8, self.device)
        else:
            out = prf.ring_bits(ks, inner, (ring or default_ring()).bits,
                                device=self.device)
        return out.reshape((len(pairs), n) + inner)


class TapeGenerator:
    """The plant of one spec on one device: ``gen(keys_stack) -> slabs``
    for ``keys_stack`` a list of N per-query party-key triples.  Each
    item is drawn for all N queries at once (:class:`_QueryBatch`), so a
    buffer costs one PRF evaluation an item, not N.  The draws run under
    ``LocalTransport`` in a ledger of their own, never in the caller's,
    and never inside a verify scope (the MSB material's B2A and ρ mult
    move shares; their digests are not the online query's).  ``ledger``
    holds one query's offline rows, from a ``meta`` run of the same
    draws."""

    def __init__(self, spec: MaterialSpec, device):
        self.spec = spec
        self.device = torch.device(device)
        keys = prf.split(prf.PRNGKey(0), PARTIES)
        with transport.use_transport(transport.LocalTransport()), \
                comm.track() as self.ledger:
            self._draw(_QueryBatch([keys], "meta"))

    def _draw(self, p: _QueryBatch) -> dict:
        """{slab key: [slab row of each slot]}, each row (3, N, *s) or
        (N, *s)."""
        n = len(p.keys_stack)
        vals: dict[str, list] = {}
        for it, (base, _slot) in zip(self.spec.items, self.spec.index):
            p._cnt = it.cnt    # seek to the traced counter value
            batched = dataclasses.replace(it, shape=(n,) + it.shape)
            for suffix, arr in _draw_inline(p, batched).items():
                if it.kind == "ot_masks":      # (2, N, *s) -> (N, 2, *s)
                    arr = arr.movedim(0, 1)
                vals.setdefault(base + suffix, []).append(arr)
        return vals

    def __call__(self, keys_stack) -> dict:
        if integrity.active() is not None:
            raise RuntimeError("the tape plant must run outside a "
                               "verify_scope")
        with transport.use_transport(transport.LocalTransport()), \
                comm.track():
            vals = self._draw(_QueryBatch(keys_stack, self.device))
        # slots stack after the query axis: (3, N, n, *s) or (N, n, *s)
        return {k: torch.stack(v, dim=1 if self.spec.slabs[k].layout
                               == REPLICATED else 2)
                for k, v in vals.items()}


def make_tape_generator(spec: MaterialSpec, device="cpu") -> TapeGenerator:
    """The plant of ``spec`` on ``device``, cached on the spec."""
    key = str(torch.device(device))
    if key not in spec._gen:
        spec._gen[key] = TapeGenerator(spec, device)
    return spec._gen[key]


def tape_session_keys(session_key: prf.Key, n_queries: int) -> list:
    """N fresh per-query party-key triples from one session key (the
    reference's ``vmap(split(k, 3))(split(session_key, N))``)."""
    return [prf.split(k, PARTIES) for k in prf.split(session_key, n_queries)]


@dataclasses.dataclass
class MaterialTape:
    """N queries' worth of correlated randomness, ready to consume."""

    slabs: dict
    spec: MaterialSpec
    n_queries: int

    def query_slice(self, q: int) -> dict:
        """The per-query slab dict of slot ``q`` (views, no copy)."""
        return {k: (v[:, q] if self.spec.slabs[k].layout != REPLICATED
                    else v[q])
                for k, v in self.slabs.items()}

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.slabs.values())


def generate_tape(spec: MaterialSpec, keys_stack,
                  device="cpu") -> MaterialTape:
    """The tape of ``keys_stack`` (N per-query party-key triples)."""
    slabs = make_tape_generator(spec, device)(keys_stack)
    return MaterialTape(slabs, spec, len(keys_stack))


# ---------------------------------------------------------------------------
# The consumable: tape-backed Parties
# ---------------------------------------------------------------------------

class TapeParties(Parties):
    """Drop-in ``Parties`` that consumes one query's tape slice in spec
    order instead of evaluating the PRF: the online phase of the plant.
    Every draw checks (kind, shape, aux, ring) against the spec and the
    slabs it reads against the active transport's layout, so a program
    drift since ``trace_material`` fails loudly."""

    def __init__(self, keys, slabs: dict, spec: MaterialSpec):
        dev = next(iter(slabs.values())).device if slabs else "cpu"
        super().__init__(keys, device=dev)
        self.slabs = slabs
        self.spec = spec
        self._pos = 0

    def fresh(self):
        self._pos = 0
        self._cnt = self._base
        return self

    def _take(self, kind, shape, aux, ring):
        if self._pos >= len(self.spec.items):
            raise MaterialDesyncError(
                f"material tape exhausted: online program drew more than "
                f"the {len(self.spec.items)} traced items (kind={kind})")
        it = self.spec.items[self._pos]
        base, slot = self.spec.index[self._pos]
        shape = tuple(int(d) for d in shape)
        if (it.kind, it.shape, it.aux, it.ring) != (kind, shape, aux, ring):
            raise MaterialDesyncError(
                f"material tape desync at draw {self._pos} (kind={it.kind!r} "
                f"cnt={it.cnt}): traced "
                f"{(it.kind, it.shape, it.aux, it.ring)}, online asked "
                f"{(kind, shape, aux, ring)} — retrace the MaterialSpec")
        self._validate_slabs(it, base)
        self._pos += 1
        return base, slot

    def _validate_slabs(self, it: MaterialItem, base: str):
        """The slabs this draw reads: the item's dtype, its trailing shape
        and the party-axis layout the active transport consumes."""
        t = transport.current()
        lead = {STACK_PAIR: t.rss_slots, STACK_PARTS: t.parts_slots,
                REPLICATED: 0}
        inner = _inner(it)
        for suffix, layout, dt in _KIND_FIELDS[it.kind]:
            arr = self.slabs.get(base + suffix)
            dtype = _field_dtype(dt, it.ring)
            n_lead = lead[layout]
            # (slots?, n_slots, *inner): one slab axis per traced slot
            want_ndim = (1 if n_lead == 0 else 2) + len(inner)
            ok = (arr is not None and arr.dtype == dtype
                  and arr.ndim == want_ndim
                  and (not inner
                       or tuple(int(d) for d in arr.shape[-len(inner):])
                       == inner)
                  and (n_lead == 0 or int(arr.shape[0]) == n_lead))
            if not ok:
                got = (None if arr is None
                       else f"{tuple(arr.shape)} {arr.dtype}")
                raise MaterialDesyncError(
                    f"material tape desync at draw {self._pos}: slab "
                    f"{base + suffix!r} for kind={it.kind!r} cnt={it.cnt} "
                    f"is {got}, expected party lead {n_lead or 'none'} + "
                    f"tail {inner} {dtype} under the "
                    f"{type(t).__name__} layout")

    # -- draw points ---------------------------------------------------------
    def zero_shares(self, shape, ring=None):
        base, slot = self._take("zero", shape, (), ring or default_ring())
        return self.slabs[base][:, slot]

    def rand_rss(self, shape, ring=None, max_bits=None):
        ring = ring or default_ring()
        base, slot = self._take("rss", shape, (max_bits,), ring)
        return RSS(self.slabs[base][:, slot], ring)

    def rand_bits(self, shape):
        base, slot = self._take("bits", shape, (), default_ring())
        return BinRSS(self.slabs[base][:, slot])

    def common_pair(self, a, b, shape, ring=None):
        base, slot = self._take("pair", shape, (a, b),
                                ring or default_ring())
        return self.slabs[base][slot]

    def private_to(self, i, shape, ring=None):
        base, slot = self._take("private", shape, (i,),
                                ring or default_ring())
        return self.slabs[base][slot]

    def ot_masks(self, kidx, shape, ring=None):
        base, slot = self._take("ot_masks", shape, (kidx,),
                                ring or default_ring())
        m = self.slabs[base][slot]
        return m[0], m[1]

    def msb_material(self, shape, ring, r_bits, tag="msb"):
        base, slot = self._take("msb", shape, (r_bits,), ring)
        return (BinRSS(self.slabs[base + ".beta"][:, slot]),
                RSS(self.slabs[base + ".beta_a"][:, slot], ring),
                RSS(self.slabs[base + ".rho"][:, slot], ring))

    def rand_rss_open(self, shape, ring=None):
        raise NotImplementedError(
            "rand_rss_open (truncate_probabilistic baseline) is inline-only")


# ---------------------------------------------------------------------------
# The pool: bounded, accounted, backpressured tape supply
# ---------------------------------------------------------------------------

class TapePool:
    """Double-buffered supply of per-query tape slices with explicit
    accounting (DESIGN.md §14).

    The next buffer is generated as one drains (``prefetch``), outside
    the online query; the eager plant enqueues its work on the device's
    stream as it goes.  Every buffer is demand-gated: with ``demand``
    slices declared up front the pool never generates a buffer no query
    will consume.  Underrun is explicit: when consumption overtakes the
    supply the pool refills synchronously and warns (backpressure); when
    the budget (``demand`` or ``max_buffers``) is spent it raises
    :class:`~repro_torch.core.integrity.PoolExhaustedError` rather than
    replay consumed randomness.  ``verify=True`` checks every slice's
    structure against the spec (``--verify full``)."""

    def __init__(self, gen, spec: MaterialSpec, depth: int,
                 master_key: prf.Key, demand: int | None = None,
                 max_buffers: int | None = None, verify: bool = False,
                 prefetch: bool = True):
        if depth < 1:
            raise ValueError(f"pool depth must be >= 1, got {depth}")
        self.gen = gen
        self.spec = spec
        self.depth = depth
        self.master_key = master_key
        self.demand = demand
        self.max_buffers = max_buffers
        self.verify = verify
        self.prefetch = prefetch   # generate the next buffer ahead of need
        self.taken = 0
        self.generated = 0   # buffers generated so far
        self.refills = 0     # buffers beyond the initial one
        self._bufs: list = []    # FIFO of [MaterialTape, next slot]
        self._warned_dry = False
        self._prefetch()
        if prefetch:
            self._prefetch()

    def _want_more(self) -> bool:
        if self.max_buffers is not None and self.generated >= self.max_buffers:
            return False
        if self.demand is not None \
                and self.generated * self.depth >= self.demand:
            return False
        return True

    def _prefetch(self):
        if not self._want_more():
            return
        with telemetry.span(f"tape_refill[{self.generated}]", cat="offline",
                            depth=self.depth):
            keys = tape_session_keys(
                prf.fold_in(self.master_key, self.generated), self.depth)
            self._bufs.append([MaterialTape(self.gen(keys), self.spec,
                                            self.depth), 0])
        self.generated += 1
        if self.generated > 1:
            self.refills += 1
            telemetry.inc("pool_refills_total")

    @property
    def supply(self) -> int:
        """Slices generated and not yet consumed."""
        return self.generated * self.depth - self.taken

    def take(self) -> dict:
        """The next per-query slab slice, generating the next buffer as one
        drains.  Warns on backpressure, raises
        :class:`PoolExhaustedError` when the budget is spent."""
        if self._bufs and self._bufs[0][1] >= self.depth:
            self._bufs.pop(0)       # drained: swap + prefetch the next
            if self.prefetch:
                self._prefetch()
        if not self._bufs:
            if not self._want_more():
                raise PoolExhaustedError(
                    f"material pool exhausted after {self.taken} slices: "
                    f"offline budget spent ({self.generated} buffers x "
                    f"depth {self.depth}"
                    + (f", demand {self.demand}" if self.demand else "")
                    + ") — raise --pool-depth or the buffer budget")
            # backpressure: budget remains but no buffer is ready — the
            # online phase blocks on a synchronous refill
            warnings.warn(
                "tape pool underrun: online phase blocked on a "
                "synchronous refill (offline plant is falling behind)",
                RuntimeWarning, stacklevel=2)
            telemetry.inc("pool_backpressure_total")
            self._prefetch()
        if self.demand is not None and not self._warned_dry \
                and self.demand - self.taken > self.supply \
                and not self._want_more():
            self._warned_dry = True
            warnings.warn(
                f"tape pool nearly exhausted: {self.supply} slices left "
                f"for {self.demand - self.taken} demanded — later queries "
                f"will abort with PoolExhaustedError",
                RuntimeWarning, stacklevel=2)
        tape, slot = self._bufs[0]
        self._bufs[0][1] += 1
        self.taken += 1
        if telemetry.enabled():
            telemetry.gauge("pool_supply", self.supply)
        sl = tape.query_slice(slot)
        if self.verify:
            verify_tape_slice(self.spec, sl)
        return sl


# ---------------------------------------------------------------------------
# Online-phase helpers
# ---------------------------------------------------------------------------

def make_tape_infer(model, spec: MaterialSpec, reveal_output: bool = True):
    """The online runner ``run(keys, x_stack, slabs) -> logits`` consuming
    one tape slice: no PRF evaluation, the ledger's online rows only."""
    from .secure_model import secure_infer

    def run(keys, x_stack, slabs):
        tp = TapeParties(keys, slabs, spec)
        return secure_infer(model, RSS(x_stack, model.ring), tp,
                            reveal_output=reveal_output)

    return run


def online_cost(model, spec: MaterialSpec, input_shape) -> comm.CommLedger:
    """Ledger of the tape-backed online query (a ``meta`` run): exactly
    the inline ledger's online (non-``pre:``) rows."""
    keys = prf.split(prf.PRNGKey(0), PARTIES)
    x = torch.empty((PARTIES,) + tuple(input_shape), dtype=model.ring.dtype)
    return comm.estimate_cost(
        lambda m, xs, sl: make_tape_infer(m, spec)(keys, xs, sl),
        model, x, spec.slab_structs())
