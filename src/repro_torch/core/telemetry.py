"""Secure-runtime observability: tracing, metrics, attribution (§17).

Port of ``repro/core/telemetry.py`` (``Tracer``, ``Span``, ``tracing`` /
``span`` / ``enabled``, ``MetricsRegistry``, ``collecting``, ``inc`` /
``gauge`` / ``observe`` / ``movement``, ``attribution`` /
``AttributionReport`` / ``ledger_groups``, ``validate_chrome_trace``,
``PHASES``).  The framework predicts every byte and round byte-exactly
(core/cost_model.py pinned against the CommLedger), but prediction is not
observation — this module is the measurement substrate the serving stack
reports through:

:class:`Tracer`
    Nested spans over the runtime's phases (compile, the ledger's meta
    run, the warm-up, each query), exported as Chrome trace-event JSON
    (load in Perfetto / ``chrome://tracing``) in the reference's schema.
    Spans keep host ``perf_counter`` times; on a CUDA tracer an
    ``online`` span also records a pair of CUDA events on the current
    stream, read once at export into ``args["device_ms"]``, so a query
    span shows the device's time beside the host's enqueue time.
    Protocol-op correlation rides ``comm.add_listener``: while a span is
    open, every ``comm.record`` lands as an instant event carrying the
    op's tag, rounds and wire bytes, and accumulates onto the enclosing
    span's ``args``.  The reference's listeners fire at jax *trace* time
    (once per compiled program); the port runs eagerly, so they fire
    **on every query** and each query span carries that query's ops.
    Spans recorded with ``lane="parties"`` fan out into one lane per
    party when the tracer declares ``parties``.

:class:`MetricsRegistry`
    Counters (rounds / wire bytes by §11 path tag, transport movement
    ops), histograms (per-query latency with p50/p95/p99) and gauges —
    exported as JSON and as Prometheus text exposition format.  Comm
    counters come from the per-query ledger × queries
    (:meth:`MetricsRegistry.record_ledger`), never from the listener as
    well; movement counters count every op as it runs, so they are
    per query while a registry is installed.

:func:`attribution`
    The predicted-vs-measured report: one row per compiled layer
    joining the §15 cost-model prediction (``model.predicted``), the
    live ``CommLedger`` grouped by layer tag, and the measured online
    span time distributed by predicted time share.  The per-row
    measured wire bytes sum to the ledger total *exactly* (pinned in
    tests/test_telemetry.py) — the report can never disagree with the
    accounting it summarizes.

Disabled-mode cost contract: with no tracer/registry installed every
hook in the runtime (the transport's movement ops, the serving loop's
spans) is a single ``is None`` module attribute test — no allocation, no
event, no clock read, no string formatting.  ``chip_smoke.py`` measures
the serving rate with telemetry off and on in one run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time

import torch

from . import comm

__all__ = ["Span", "Tracer", "tracing", "tracer", "span", "enabled",
           "MetricsRegistry", "collecting", "metrics", "inc", "gauge",
           "observe", "movement", "attribution", "AttributionReport",
           "AttributionRow", "ledger_groups", "validate_chrome_trace",
           "PHASES"]

# span taxonomy (DESIGN.md §17): every span names one of these categories
PHASES = ("setup", "compile", "offline", "online", "verify", "report")

_US = 1e6   # trace-event timestamps are microseconds


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Span:
    """One closed wall-clock interval (Chrome trace-event "X" phase)."""

    name: str
    cat: str                 # one of PHASES
    ts: float                # start, seconds on the tracer's clock
    dur: float = 0.0         # seconds
    lane: str = "main"       # exporter tid; "parties" fans out per party
    depth: int = 0           # nesting depth at open time
    args: dict = dataclasses.field(default_factory=dict)
    # (start, end) CUDA events of an online span on a CUDA tracer
    events: tuple | None = dataclasses.field(default=None, repr=False)

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's events (waits for the
        end event), or None without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])

    def add_comm(self, tag: str, rounds: int, nbytes: int,
                 preprocess: bool) -> None:
        """Accumulate one ``comm.record`` event onto this span."""
        pre = "pre_" if preprocess else ""
        self.args[pre + "rounds"] = self.args.get(pre + "rounds", 0) + rounds
        self.args[pre + "wire_bytes"] = (self.args.get(pre + "wire_bytes", 0)
                                         + nbytes)
        self.args["comm_ops"] = self.args.get("comm_ops", 0) + 1


class Tracer:
    """Collects :class:`Span`s and instant events; exports a Chrome
    trace.  One tracer serves one serving run; activate it with
    :func:`tracing` so the module-level hooks (and the ``comm.record``
    listener) see it.

    ``parties`` > 0 declares a party count: spans recorded with
    ``lane="parties"`` are exported once per party lane (the three
    parties run one schedule in lockstep, so one measured interval is
    every party's interval).  ``device`` (a CUDA device) makes every
    ``online`` span record a pair of CUDA events on its current stream."""

    def __init__(self, parties: int = 0, clock=time.perf_counter,
                 device=None):
        self.clock = clock
        self.parties = parties
        dev = torch.device(device) if device is not None else None
        self.device = dev if dev is not None and dev.type == "cuda" \
            else None
        self.spans: list[Span] = []
        self.instants: list[tuple] = []   # (name, cat, ts, lane, args)
        self._open: list[Span] = []
        self._t0 = clock()

    # -- recording -------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, cat: str = "online", lane: str = "main",
             **args):
        s = Span(name=name, cat=cat, ts=self.clock(), lane=lane,
                 depth=len(self._open), args=dict(args))
        if cat == "online" and self.device is not None:
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record(torch.cuda.current_stream(self.device))
        self._open.append(s)
        try:
            yield s
        finally:
            if s.events is not None:
                s.events[1].record(torch.cuda.current_stream(self.device))
            s.dur = self.clock() - s.ts
            self._open.pop()
            self.spans.append(s)

    def instant(self, name: str, cat: str = "online", lane: str = "main",
                **args):
        self.instants.append((name, cat, self.clock(), lane, args))

    def on_comm(self, tag, rounds, nbytes, preprocess):
        """``comm.add_listener`` hook: attribute protocol-op records to
        the innermost open span (they fire as the protocols run, so each
        query span gets its own query's ops)."""
        if not self._open:
            return
        self._open[-1].add_comm(tag, rounds, nbytes, preprocess)
        self.instants.append(
            ("pre:" + tag if preprocess else tag, "comm", self.clock(),
             self._open[-1].lane,
             {"rounds": rounds, "wire_bytes": nbytes}))

    # -- export ----------------------------------------------------------
    def _lanes(self) -> dict[str, int]:
        """Stable lane -> tid map; party lanes get the trailing tids."""
        lanes = {"main": 0}
        for s in self.spans:
            if s.lane not in ("main", "parties") and s.lane not in lanes:
                lanes[s.lane] = len(lanes)
        for name, _, _, lane, _ in self.instants:
            if lane not in ("main", "parties") and lane not in lanes:
                lanes[lane] = len(lanes)
        for p in range(self.parties):
            # a span may name its party lane itself (the mesh's rank spans)
            lanes.setdefault(f"party{p}", len(lanes))
        return lanes

    def _fan(self, lane: str) -> list[str]:
        if lane == "parties" and self.parties:
            return [f"party{p}" for p in range(self.parties)]
        return [lane if lane != "parties" else "main"]

    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto-
        loadable): one process, one tid per lane, "X" complete events
        for spans, "i" instants for comm/protocol ops, "M" metadata
        naming the lanes."""
        lanes = self._lanes()
        ev = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "cbnn-secure-runtime"}}]
        for lane, tid in lanes.items():
            ev.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": lane}})
        for s in self.spans:
            args = dict(s.args)
            dms = s.device_ms()
            if dms is not None:
                args["device_ms"] = dms
            for lane in self._fan(s.lane):
                ev.append({"name": s.name, "cat": s.cat, "ph": "X",
                           "ts": (s.ts - self._t0) * _US,
                           "dur": s.dur * _US, "pid": 0,
                           "tid": lanes[lane], "args": dict(args)})
        for name, cat, ts, lane, args in self.instants:
            for ln in self._fan(lane):
                ev.append({"name": name, "cat": cat, "ph": "i",
                           "ts": (ts - self._t0) * _US, "pid": 0,
                           "tid": lanes[ln], "s": "t",
                           "args": dict(args)})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"generator": "repro_torch.core.telemetry"}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    # -- queries ---------------------------------------------------------
    def phase_seconds(self) -> dict[str, float]:
        """Total wall seconds per category, counting top-level-within-
        category spans only (a span nested under a same-category parent
        is already covered by the parent's interval)."""
        out: dict[str, float] = {}
        stack: list[Span] = []
        for s in sorted(self.spans, key=lambda s: (s.ts, -s.dur)):
            while stack and s.ts >= stack[-1].ts + stack[-1].dur:
                stack.pop()
            if not any(p.cat == s.cat for p in stack):
                out[s.cat] = out.get(s.cat, 0.0) + s.dur
            stack.append(s)
        return out


def validate_chrome_trace(trace: dict) -> None:
    """Assert ``trace`` is schema-valid Chrome trace-event JSON (object
    format).  Raises ``ValueError`` naming the first offending event —
    the test-time gate that keeps exports Perfetto-loadable."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    for i, e in enumerate(events):
        def bad(msg):
            raise ValueError(f"traceEvents[{i}] {msg}: {e!r}")
        if not isinstance(e, dict):
            bad("is not an object")
        ph = e.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "M", "C"):
            bad(f"has unsupported phase {ph!r}")
        if not isinstance(e.get("name"), str) or not e["name"]:
            bad("is missing a string 'name'")
        if not isinstance(e.get("pid"), int):
            bad("is missing an int 'pid'")
        if not isinstance(e.get("tid"), int):
            bad("is missing an int 'tid'")
        if "args" in e and not isinstance(e["args"], dict):
            bad("has non-object 'args'")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            bad("needs a finite non-negative 'ts' (microseconds)")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or not math.isfinite(dur) \
                    or dur < 0:
                bad("complete event needs a finite non-negative 'dur'")


# module-level activation: the disabled fast path everywhere in the
# runtime is a single `_TRACER is None` / `_METRICS is None` test
_TRACER: Tracer | None = None
_METRICS: "MetricsRegistry | None" = None

_NULL = contextlib.nullcontext()


def tracer() -> Tracer | None:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None or _METRICS is not None


def span(name: str, cat: str = "online", lane: str = "main", **args):
    """Module-level span: records on the active tracer, free when none
    is installed (returns a shared null context)."""
    if _TRACER is None:
        return _NULL
    return _TRACER.span(name, cat, lane, **args)


@contextlib.contextmanager
def tracing(t: Tracer | None):
    """Install ``t`` as the active tracer (and its comm listener) for
    the enclosed block.  ``None`` is a no-op, so call sites need no
    branching."""
    global _TRACER
    if t is None:
        yield None
        return
    prev = _TRACER
    _TRACER = t
    comm.add_listener(t.on_comm)
    try:
        yield t
    finally:
        comm.remove_listener(t.on_comm)
        _TRACER = prev


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

_QUANTILES = (0.5, 0.95, 0.99)


def _labelstr(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank-with-interpolation percentile of a sorted sample."""
    if not sorted_vals:
        return float("nan")
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class MetricsRegistry:
    """Counters, gauges, and sample-backed histograms keyed by
    ``(name, sorted labels)``; exports JSON and Prometheus text
    exposition format (histograms as summaries with quantile labels).

    All metric names are exported under the ``cbnn_`` prefix.  The
    registry is host-side and unsynchronized by design — the secure
    runtime drives it from one serving thread."""

    PREFIX = "cbnn_"

    def __init__(self):
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        self.histograms: dict[tuple, list] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    def inc(self, name: str, value: float = 1.0, **labels):
        k = self._key(name, labels)
        self.counters[k] = self.counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels):
        self.gauges[self._key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels):
        self.histograms.setdefault(self._key(name, labels),
                                   []).append(float(value))

    # -- export ----------------------------------------------------------
    def _hist_stats(self, samples: list) -> dict:
        vals = sorted(samples)
        stats = {"count": len(vals), "sum": sum(vals),
                 "min": vals[0], "max": vals[-1]}
        for q in _QUANTILES:
            stats[f"p{int(q * 100)}"] = _percentile(vals, q)
        return stats

    def as_dict(self) -> dict:
        """JSON-able snapshot: {counters: {...}, gauges: {...},
        histograms: {name{labels}: {count,sum,min,max,p50,p95,p99}}}."""
        def flat(d):
            return {name + _labelstr(dict(lbl)): v
                    for (name, lbl), v in sorted(d.items())}
        return {"counters": flat(self.counters),
                "gauges": flat(self.gauges),
                "histograms": {name + _labelstr(dict(lbl)):
                               self._hist_stats(v)
                               for (name, lbl), v in
                               sorted(self.histograms.items())}}

    def prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []

        def emit(d, mtype, suffix=""):
            seen = set()
            for (name, lbl), v in sorted(d.items()):
                full = self.PREFIX + name + suffix
                if full not in seen:
                    lines.append(f"# TYPE {full} {mtype}")
                    seen.add(full)
                lines.append(f"{full}{_labelstr(dict(lbl))} {v}")

        emit(self.counters, "counter")
        emit(self.gauges, "gauge")
        seen = set()
        for (name, lbl), samples in sorted(self.histograms.items()):
            full = self.PREFIX + name
            if full not in seen:
                lines.append(f"# TYPE {full} summary")
                seen.add(full)
            stats = self._hist_stats(samples)
            for q in _QUANTILES:
                ql = dict(lbl)
                ql["quantile"] = f"{q:g}"
                lines.append(f"{full}{_labelstr(ql)} {stats[f'p{int(q*100)}']}")
            lines.append(f"{full}_sum{_labelstr(dict(lbl))} {stats['sum']}")
            lines.append(
                f"{full}_count{_labelstr(dict(lbl))} {stats['count']}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    def write_prom(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus())

    def record_ledger(self, led: comm.CommLedger, model=None,
                      queries: int = 1) -> None:
        """Fold a per-query :class:`CommLedger` into the comm counters,
        scaled by the served query count.  When ``model`` carries §11
        path labels (``op["path"]``) each tag's counter also gets a
        ``path`` label, so bytes roll up by protocol path."""
        paths = {}
        if model is not None:
            for i, op in enumerate(model.ops):
                p = op.get("path")
                if p is not None:
                    paths[f"l{i}"] = (p if isinstance(p, str)
                                      else "+".join(p))
        for tag, (r, b) in led.by_tag.items():
            phase = "offline" if tag.startswith("pre:") else "online"
            head = tag.split(":", 1)[-1].split(".", 1)[0]
            labels = {"tag": tag, "phase": phase}
            if head in paths:
                labels["path"] = paths[head]
            self.inc("comm_rounds_total", r * queries, **labels)
            self.inc("comm_bytes_total", b * queries, **labels)


@contextlib.contextmanager
def collecting(reg: MetricsRegistry | None):
    """Install ``reg`` as the active registry (``None`` = no-op)."""
    global _METRICS
    if reg is None:
        yield None
        return
    prev = _METRICS
    _METRICS = reg
    try:
        yield reg
    finally:
        _METRICS = prev


def metrics() -> MetricsRegistry | None:
    return _METRICS


def inc(name: str, value: float = 1.0, **labels):
    if _METRICS is not None:
        _METRICS.inc(name, value, **labels)


def gauge(name: str, value: float, **labels):
    if _METRICS is not None:
        _METRICS.gauge(name, value, **labels)


def observe(name: str, value: float, **labels):
    if _METRICS is not None:
        _METRICS.observe(name, value, **labels)


def movement(kind: str, backend: str):
    """Transport movement-op hook (complete / open / send): counts every
    op as it runs, so per query while a registry is installed (the
    reference counts once per compiled program).  With no registry it is
    one attribute test."""
    if _METRICS is not None:
        _METRICS.inc("transport_ops_total", 1.0, kind=kind, backend=backend)


# ---------------------------------------------------------------------------
# Predicted-vs-measured attribution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AttributionRow:
    """One layer (or extra ledger group) of the attribution table."""

    name: str                 # cost-model entry name, e.g. "l0 (conv)"
    path: str                 # §11 path label ("-" for non-linear ops)
    pred_rounds: int
    pred_bytes: int
    meas_rounds: int
    meas_bytes: int
    pre_bytes: int            # measured offline bytes of the group
    share: float              # meas_bytes / ledger online total
    attr_ms: float | None     # measured online wall time x predicted share
    tags: tuple = ()          # the ledger tags folded into this row
    has_pred: bool = True     # False: ledger-only group (e.g. verify)

    @property
    def exact(self) -> bool:
        """Prediction agrees with the ledger (vacuously true for
        ledger-only groups, which predict nothing)."""
        if not self.has_pred:
            return True
        return (self.pred_rounds, self.pred_bytes) == \
            (self.meas_rounds, self.meas_bytes)


@dataclasses.dataclass
class AttributionReport:
    rows: list
    ledger_rounds: int
    ledger_bytes: int
    online_s: float | None = None
    deployment: str | None = None

    @property
    def exact(self) -> bool:
        """Predicted == measured on every row that has a prediction."""
        return all(r.exact for r in self.rows)

    def render(self) -> str:
        """The human-readable predicted-vs-measured table."""
        hdr = (f"{'layer':<16} {'path':<22} {'pred r/B':>16} "
               f"{'meas r/B':>16} {'Δ':>3} {'%B':>6} {'attr ms':>8}")
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows:
            d = "ok" if r.exact else "!!"
            attr = f"{r.attr_ms:8.2f}" if r.attr_ms is not None else \
                f"{'-':>8}"
            lines.append(
                f"{r.name:<16} {r.path:<22} "
                f"{r.pred_rounds:>4}/{r.pred_bytes:>11,} "
                f"{r.meas_rounds:>4}/{r.meas_bytes:>11,} {d:>3} "
                f"{r.share * 100:>5.1f}% {attr}")
        foot = (f"{'total':<16} {'':<22} "
                f"{sum(r.pred_rounds for r in self.rows):>4}/"
                f"{sum(r.pred_bytes for r in self.rows):>11,} "
                f"{self.ledger_rounds:>4}/{self.ledger_bytes:>11,}")
        lines.append("-" * len(hdr))
        lines.append(foot)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {"deployment": self.deployment, "online_s": self.online_s,
                "ledger_rounds": self.ledger_rounds,
                "ledger_bytes": self.ledger_bytes,
                "exact": self.exact,
                "rows": [dataclasses.asdict(r) for r in self.rows]}


def ledger_groups(led: comm.CommLedger) -> dict[str, list]:
    """Group the ledger's tags by layer head (the token before the first
    ``.``, ``pre:`` stripped): head -> [rounds, bytes, pre_rounds,
    pre_bytes, tags].  Heads are the executor's tag discipline —
    ``l{i}`` / ``sign{i}`` / ``relu{i}`` / ``aff{i}`` / ``mp{i}`` /
    ``output`` / ``verify`` — so the grouping is exhaustive by
    construction; anything else still lands in its own group (the
    report never drops bytes)."""
    groups: dict[str, list] = {}
    for tag, (r, b) in led.by_tag.items():
        pre = tag.startswith("pre:")
        head = tag.split(":", 1)[-1].split(".", 1)[0]
        g = groups.setdefault(head, [0, 0, 0, 0, []])
        if pre:
            g[2] += r
            g[3] += b
        else:
            g[0] += r
            g[1] += b
        g[4].append(tag)
    return groups


def attribution(predicted, led: comm.CommLedger, *,
                online_s: float | None = None,
                deployment=None) -> AttributionReport:
    """Join the cost-model prediction (a ``CostReport`` traced at the
    *serving* batch shape — e.g. ``cost_model.model_cost(model,
    (B,) + shape)``, or ``None`` when no per-layer prediction exists,
    as on the LM path), the live per-query ledger, and the measured
    online wall time into the per-layer predicted-vs-measured table.

    ``online_s`` (measured seconds per query, e.g. the tracer's online
    phase total / queries) is distributed across rows by each row's
    *predicted* time share under ``deployment`` (default LAN; measured
    byte share when no prediction exists) — wall attribution below one
    compiled program is a model-weighted split, and the column says so.
    Measured rounds/bytes per row come from the ledger alone and sum to
    its totals exactly."""
    from . import cost_model

    dep = cost_model.resolve_deployment(deployment) or cost_model.LAN
    groups = ledger_groups(led)
    rows: list[AttributionRow] = []
    times = []
    entries = predicted.entries if predicted is not None else []
    for e in entries:
        head = e.name.split(" ", 1)[0]
        g = groups.pop(head, [0, 0, 0, 0, []])
        path = e.path if isinstance(e.path, str) else "+".join(e.path)
        rows.append(AttributionRow(
            name=e.name, path=path, pred_rounds=e.cost.rounds,
            pred_bytes=e.cost.nbytes, meas_rounds=g[0], meas_bytes=g[1],
            pre_bytes=g[3], share=0.0, attr_ms=None, tags=tuple(g[4])))
        times.append(e.cost.time(dep))
    for head in sorted(groups):   # ledger-only groups (e.g. verify.digest)
        g = groups[head]
        rows.append(AttributionRow(
            name=head, path="-", pred_rounds=0, pred_bytes=0,
            meas_rounds=g[0], meas_bytes=g[1], pre_bytes=g[3], share=0.0,
            attr_ms=None, tags=tuple(g[4]), has_pred=False))
        times.append(0.0)
    total_b = max(led.nbytes, 1)
    total_t = sum(times)
    for r, t in zip(rows, times):
        r.share = r.meas_bytes / total_b
        if online_s is not None:
            w = t / total_t if total_t > 0 else r.share
            r.attr_ms = online_s * 1e3 * w
    return AttributionReport(rows=rows, ledger_rounds=led.rounds,
                             ledger_bytes=led.nbytes, online_s=online_s,
                             deployment=dep.name)
