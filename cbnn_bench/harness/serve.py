"""Set-up and the measured window of one cell, on the system's own serving
entries (``repro_torch.launch.serve_secure``).

Set-up: the weights and images from the seed (inputs.py), ``build`` (BN
folds, secret sharing, kernel operand caches), the runner (``make_runner``,
or ``make_tape_runner`` on a ``TapePool`` fed by ``make_tape_generator``
in a pool cell), and warm-up queries that build and load every kernel the
window launches.  The window is a closed loop of one client: each query
secret-shares its batch (``core.rss.share``), takes a tape slice in a pool
cell, runs the runner and copies the opened logits to the host; the next
query is issued when they arrive.  Every query draws fresh sharing and
party keys from the seed; the images cycle over a few distinct batches.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time

import torch

from . import inputs, trace as tracing

__all__ = ["run_window", "TRAFFIC_KEYS"]

clock = time.perf_counter
# every key a traffic file may hold; "pool_depth" only with offline "pool"
TRAFFIC_KEYS = frozenset({"about", "weights", "offline", "batch",
                          "pool_depth", "distinct_batches", "warmup_queries",
                          "profile_queries", "profile_after_share"})


def _check_traffic(traffic: dict) -> None:
    """Refuse a key that the window does not read, so that a new knob in a
    traffic file comes with the code that honours it."""
    unread = set(traffic) - TRAFFIC_KEYS
    if traffic.get("offline") != "pool":
        unread |= set(traffic) & {"pool_depth"}
    if unread:
        raise ValueError(f"traffic keys the window does not read: "
                         f"{sorted(unread)}")


@contextlib.contextmanager
def _steady_host(device):
    """The window's host side: the set-up's objects frozen out of the
    collector's sweeps, and on a card the calling thread held on one core
    (the threads it starts inherit it; the CUDA driver's do not)."""
    gc.collect()
    gc.freeze()
    pinned = None
    if device.type == "cuda" and hasattr(os, "sched_setaffinity"):
        pinned = os.sched_getaffinity(0)
        os.sched_setaffinity(0, {max(pinned)})
    try:
        yield
    finally:
        if pinned is not None:
            os.sched_setaffinity(0, pinned)
        gc.unfreeze()


def _program_layers(net: str) -> list:
    """The system's layer spec of ``net``, in the configuration's form."""
    from repro_torch.nn.bnn import ALL_NETS
    out = []
    for l in ALL_NETS[net]:
        d = {"kind": l.kind}
        if l.kind in ("conv", "sepconv", "fc"):
            d["out"] = l.out
        if l.kind in ("conv", "sepconv"):
            d.update(k=l.k, stride=l.stride, pad=l.pad)
        if l.kind == "act":
            d["act"] = l.act
        out.append(d)
    return out


def run_window(cfg: dict, traffic: dict, seed: int, seconds: float,
               device, trace: bool, t_start: float, wrap_runner=None,
               max_queries: int | None = None) -> dict:
    """Set up, serve for ``seconds``, and return the run's record: the
    window's counts and times, the answers (``(batch index, logits)`` of
    every query), the ledger of one query, the trace's reduction (with
    ``trace``) and the set-up time from ``t_start``.  ``wrap_runner``
    (tests) wraps the runner; ``max_queries`` ends the window early.
    The system's state (model, pool, runner) is gone when this returns."""
    rec = _serve(cfg, traffic, seed, seconds, torch.device(device), trace,
                 t_start, wrap_runner, max_queries)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _serve(cfg, traffic, seed, seconds, device, trace, t_start, wrap_runner,
           max_queries) -> dict:
    from repro_torch.core import comm, prf
    from repro_torch.core.linear import set_fused_rounds
    from repro_torch.core.preprocessing import (TapePool,
                                                make_tape_generator,
                                                trace_material)
    from repro_torch.core.ring import RingSpec
    from repro_torch.core.rss import share
    from repro_torch.launch import serve_secure

    if _program_layers(cfg["net"]) != cfg["layers"]:
        raise RuntimeError(f"the system's {cfg['net']} is not the network "
                           f"of configuration {cfg['name']}")
    _check_traffic(traffic)
    ring = RingSpec(**cfg["ring"])
    set_fused_rounds(cfg["fused_rounds"])
    batch, distinct = traffic["batch"], traffic["distinct_batches"]
    pool_cell = traffic["offline"] == "pool"

    images = inputs.make_images(cfg, batch, distinct, seed, device)
    params = inputs.make_params(cfg, seed, device, images.flatten(0, 1))
    session = prf.fold_in(prf.PRNGKey(seed & 0x7FFFFFFF),
                          (seed >> 31) & 0xFFFFFFFF)
    window_base, warm_base, tape_key = (prf.fold_in(session, j)
                                        for j in range(1, 4))

    probes = tracing.Probes() if trace else None
    model = serve_secure.build(cfg["net"], device=device, params=params,
                               weights=traffic["weights"],
                               binary_linear=cfg["binary_linear"])
    pool = gen = None
    if pool_cell:
        spec = trace_material(model, (batch, *cfg["input_shape"]))
        gen = make_tape_generator(spec, device)
        pool = TapePool(gen, spec, traffic["pool_depth"], tape_key,
                        demand=None, prefetch=True)
        runner = serve_secure.make_tape_runner(model, spec)
    else:
        inline = serve_secure.make_runner(model)

        def runner(keys, x, slabs):
            return inline(keys, x)
    if wrap_runner is not None:
        runner = wrap_runner(runner)

    def query(q: int, base) -> tuple:
        """One query: (issue-to-logits seconds, enqueue seconds, logits)."""
        b = q % distinct
        t_issue = clock()
        xs = share(images[b], prf.fold_in(base, 2 * q), ring)
        slabs = pool.take() if pool is not None else None
        keys = prf.split(prf.fold_in(base, 2 * q + 1), 3)
        t_call = clock()
        out = runner(keys, xs.shares, slabs)
        t_ret = clock()
        logits = out.float().cpu()
        return clock() - t_issue, t_ret - t_call, logits

    for w in range(traffic["warmup_queries"]):   # the last one's ledger
        with comm.track() as led:
            query(w, warm_base)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    offline_led = gen.ledger if gen is not None else led
    ledger = {"online_bytes": led.nbytes, "online_rounds": led.rounds,
              "offline_bytes": offline_led.pre_nbytes}

    # the window
    latencies, enqueue, answers = [], [], []
    profile_from = traffic["profile_after_share"] * seconds
    profiled, slicing = range(0), False
    with _steady_host(device):
        t0 = clock()
        setup_s = t0 - t_start
        q = 0
        while True:
            if probes is not None and not slicing and not profiled \
                    and clock() - t0 >= profile_from:
                profiled = range(q, q + traffic["profile_queries"])
                probes.start()
                slicing = True
            lat, enq, logits = query(q, window_base)
            latencies.append(lat)
            enqueue.append(enq)
            answers.append((q % distinct, logits))
            q += 1
            if slicing and q == profiled.stop:
                probes.stop()
                slicing = False
            if clock() - t0 >= seconds or (max_queries and q >= max_queries):
                break
        window_s = clock() - t0
        if slicing:       # the window closed inside the slice
            probes.stop()
            profiled = range(profiled.start, q)
    # the host-clock readings of a traced run come from the queries before
    # the slice: once the profiler has run, launches stay slower
    pristine = profiled.start if profiled else q
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec = {"batch": batch, "queries": q, "window_s": window_s,
           "latencies_s": latencies, "enqueue_s": enqueue[:pristine],
           "query_s": (sum(latencies[:pristine]) / pristine if pristine
                       else None),
           "setup_s": setup_s, "ledger": ledger, "answers": answers,
           "memory_peak_bytes": peak, "images": images, "params": params,
           "trace": None}
    if probes is not None:
        if profiled:
            rec["trace"] = probes.reduce(len(profiled))
    return rec

