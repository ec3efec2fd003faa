"""Communication accounting for the simulated 3-party deployment.

Port of ``repro/core/comm.py`` (``CommLedger``, ``preprocessing``,
``track``, ``record``, ``round_barrier``, ``add_listener`` /
``remove_listener`` / ``listening``, ``estimate_cost``).  Every protocol
records the messages it would send; costs depend only on shapes, so a run
on ``meta`` tensors (:func:`estimate_cost`) yields the exact ledger
without computing anything.

The reference records at jax *trace* time, so its listeners fire once per
compiled program.  The port runs eagerly: :func:`record` and every
listener fire on **every query**, so whatever counts through a listener
counts per query.

Network model of the paper: LAN 0.2 ms / 625 MBps, WAN 80 ms / 40 MBps.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Callable

__all__ = ["NetworkModel", "LAN", "WAN", "CommLedger", "track", "record",
           "preprocessing", "round_barrier", "add_listener",
           "remove_listener", "listening", "estimate_cost"]


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    name: str
    latency_s: float
    bandwidth_Bps: float

    def time(self, rounds: int, nbytes: int) -> float:
        return rounds * self.latency_s + nbytes / self.bandwidth_Bps


LAN = NetworkModel("LAN", 0.2e-3, 625e6)
WAN = NetworkModel("WAN", 80e-3, 40e6)


@dataclasses.dataclass
class CommLedger:
    """Accumulated protocol communication; offline traffic kept apart."""

    rounds: int = 0
    nbytes: int = 0
    by_tag: dict = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0, 0]))
    pre_rounds: int = 0
    pre_nbytes: int = 0

    def add(self, tag: str, rounds: int, nbytes: int,
            preprocess: bool = False):
        if preprocess:
            self.pre_rounds += rounds
            self.pre_nbytes += nbytes
            tag = "pre:" + tag
        else:
            self.rounds += rounds
            self.nbytes += nbytes
        ent = self.by_tag[tag]
        ent[0] += rounds
        ent[1] += nbytes

    def time(self, net: NetworkModel, online_only: bool = True) -> float:
        r, b = self.rounds, self.nbytes
        if not online_only:
            r, b = r + self.pre_rounds, b + self.pre_nbytes
        return net.time(r, b)

    @property
    def megabytes(self) -> float:
        return self.nbytes / 1e6

    def summary(self) -> str:
        """Per-tag breakdown, hottest online tags first (offline ``pre:``
        tags follow, against the offline total)."""
        lines = [f"total  rounds={self.rounds:4d}  bytes={self.nbytes:,} "
                 f"({self.megabytes:.4f} MB)  [pre: r={self.pre_rounds} "
                 f"b={self.pre_nbytes:,}]"]
        online = [(t, rb) for t, rb in self.by_tag.items()
                  if not t.startswith("pre:")]
        offline = [(t, rb) for t, rb in self.by_tag.items()
                   if t.startswith("pre:")]
        for group, total in ((online, self.nbytes), (offline, self.pre_nbytes)):
            for tag, (r, b) in sorted(group, key=lambda kv: (-kv[1][1], kv[0])):
                pct = 100.0 * b / total if total else 0.0
                lines.append(f"  {tag:28s} rounds={r:4d}  bytes={b:,}"
                             f"  ({pct:5.1f}%)")
        return "\n".join(lines)


_STACK: list[CommLedger] = []
_PREPROCESS_DEPTH = 0
# observers of every record() call, ledger or not (telemetry's span
# annotations); they fire on every query in the eager port
_LISTENERS: list[Callable] = []


def add_listener(fn: Callable) -> None:
    """Register ``fn(tag, rounds, nbytes, preprocess)`` to observe every
    :func:`record` call (it fires with no ledger active too, and once per
    query: the port records as it runs, not at a trace)."""
    _LISTENERS.append(fn)


def remove_listener(fn: Callable) -> None:
    _LISTENERS.remove(fn)


@contextlib.contextmanager
def listening(fn: Callable):
    """``fn`` as a :func:`record` listener for the enclosed block, removed
    on exit even if the block raises."""
    add_listener(fn)
    try:
        yield fn
    finally:
        remove_listener(fn)


@contextlib.contextmanager
def preprocessing():
    """All comm recorded inside is input-independent offline traffic."""
    global _PREPROCESS_DEPTH
    _PREPROCESS_DEPTH += 1
    try:
        yield
    finally:
        _PREPROCESS_DEPTH -= 1


@contextlib.contextmanager
def track():
    """Collect protocol comm into a fresh ledger."""
    led = CommLedger()
    _STACK.append(led)
    try:
        yield led
    finally:
        _STACK.pop()


def record(tag: str, rounds: int, nbytes: int, preprocess: bool = False):
    """Called by protocols as they run.  The ledger add is a no-op when no
    tracker is active; listeners always fire.  A raising listener cannot
    corrupt the accounting: every listener still runs and the ledger add
    still happens, then the first listener exception propagates."""
    preprocess = preprocess or _PREPROCESS_DEPTH > 0
    err = None
    for fn in list(_LISTENERS):
        try:
            fn(tag, rounds, nbytes, preprocess)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            if err is None:
                err = e
    if _STACK:  # top-only: round_barrier propagates to its parent on exit
        _STACK[-1].add(tag, rounds, nbytes, preprocess=preprocess)
    if err is not None:
        raise err


@contextlib.contextmanager
def round_barrier(tag: str, rounds: int):
    """Group independent protocol invocations into ``rounds`` rounds:
    bytes accumulate, nested round counts are replaced by the barrier's."""
    outer = _STACK[-1] if _STACK else None
    with track() as inner:
        yield
    if outer is not None:
        outer.add(tag, rounds, inner.nbytes)
        if inner.pre_nbytes or inner.pre_rounds:
            outer.add(tag, inner.pre_rounds, inner.pre_nbytes, preprocess=True)


def _to_device(obj, device):
    """A copy of ``obj`` with every tensor moved to ``device``: through
    dicts, lists, tuples, NamedTuples (the kernels' weight caches) and
    dataclasses (``RSS``, ``PublicTensor``, ``SecureModel``); a dataclass
    field named ``device`` (``Parties``) is set to ``device`` as well."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    if isinstance(obj, tuple):
        items = [_to_device(v, device) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else type(obj)(items)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kw = {f.name: (device if f.name == "device"
                       else _to_device(getattr(obj, f.name), device))
              for f in dataclasses.fields(obj) if f.init}
        return type(obj)(**kw)
    return obj


def estimate_cost(fn: Callable, *args, **kwargs) -> CommLedger:
    """The communication ledger of ``fn(*args, **kwargs)``, from a run with
    every tensor argument (inside ``RSS``, weight caches, lists and dicts
    too) moved to ``meta``: protocols record from shapes alone, so the
    ledger is exact and nothing is computed."""
    args = _to_device(args, "meta")
    kwargs = _to_device(kwargs, "meta")
    with track() as led:
        fn(*args, **kwargs)
    return led
