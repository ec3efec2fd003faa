"""The traced slice of a ``--trace 1`` run and its reduction.

``Probes`` puts ``torch.profiler.record_function`` ranges around the
system's entries from the benchmark's side, while the slice lasts: the PRF
draw (``core.prf._threefry_tensor``, every threefry evaluation: the
protocols' randomness, the client's sharing and the tape plant) and the
four ring-product entries of ``kernels.ops`` (dense: B1 / B3; depthwise:
B2 / B4).  ``start`` installs them and profiles a slice of queries with
CPU and CUDA activities; ``stop`` ends both, so that the queries outside
the slice run the system as it is.  ``reduce`` reads the exported Chrome
trace: every device operation (kernels, copies, fills) in the slice,
attributed to a range by its launch's correlation id, the device's busy
union, and the idle gaps labelled by the innermost host operation running
across them.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

__all__ = ["Probes", "reduce_events"]

PRF, DENSE, DEPTHWISE, SLICE = ("cbnn_bench.prf", "cbnn_bench.dense",
                                "cbnn_bench.depthwise", "cbnn_bench.slice")
# (module, attribute, range) of every wrapped entry
TARGETS = (("repro_torch.core.prf", "_threefry_tensor", PRF),
           ("repro_torch.kernels.ops", "rss_matmul_parts_op", DENSE),
           ("repro_torch.kernels.ops", "bin_rss_matmul_op", DENSE),
           ("repro_torch.kernels.ops", "grouped_rss_matmul_op", DEPTHWISE),
           ("repro_torch.kernels.ops", "bin_grouped_matmul_op", DEPTHWISE))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _ranged(fn, name):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


class Probes:
    """The ranges around the system's entries, and the profiled slice."""

    def __init__(self):
        self._saved = []
        self._prof = self._slice = None
        self.host_s = {"start": 0.0, "stop": 0.0}   # the profiler's own

    def _install(self) -> None:
        import importlib
        for mod, attr, name in TARGETS:
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            self._saved.append((m, attr, fn))
            setattr(m, attr, _ranged(fn, name))

    def _uninstall(self) -> None:
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)
        self._saved = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        t = time.perf_counter()
        self._install()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._slice = torch.profiler.record_function(SLICE)
        self._slice.__enter__()
        self.host_s["start"] = time.perf_counter() - t
        return self._prof

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        t = time.perf_counter()
        self._prof.stop()
        self._uninstall()
        self.host_s["stop"] = time.perf_counter() - t

    def reduce(self, queries: int) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return {**reduce_events(events, queries),
                "profiler_start_s": self.host_s["start"],
                "profiler_stop_s": self.host_s["stop"]}


def _intervals(events, name):
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("name") == name)
    return [a for a, _ in iv], iv


def _inside(starts, iv, t) -> bool:
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and iv[j][0] <= t <= iv[j][1]


def reduce_events(events: list, queries: int) -> dict:
    """The slice's device numbers from Chrome trace ``events`` (times in
    microseconds there, seconds here)."""
    xs = [e for e in events if e.get("ph") == "X"]
    host = [e for e in xs if e.get("cat", "").lower()
            in ("user_annotation", "cpu_op")]
    gpu_ann = [e for e in xs if e.get("cat", "").lower()
               == "gpu_user_annotation"]
    sl = [e for e in host if e["name"] == SLICE]
    if len(sl) != 1:
        raise RuntimeError(f"the trace holds {len(sl)} slice ranges")
    s0, s1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    main_tid = sl[0].get("tid")
    launch_ts = {}
    for e in xs:
        if e.get("cat", "").lower() in LAUNCH_CATS \
                and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
    dev = [e for e in xs if e.get("cat", "").lower() in DEVICE_CATS
           and e["ts"] < s1 and e["ts"] + e.get("dur", 0) > s0]
    ranges = {n: _intervals(host, n) for n in (PRF, DENSE, DEPTHWISE)}
    gpu_ranges = {n: _intervals(gpu_ann, n) for n in (PRF, DENSE, DEPTHWISE)}
    in_range = {n: 0.0 for n in ranges}
    by_name: dict[str, float] = {}
    kernels = 0
    for e in dev:
        dur = e.get("dur", 0)
        if e.get("cat", "").lower() == "kernel":
            kernels += 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        for n in ranges:
            hit = (_inside(*ranges[n], t) if t is not None
                   else _inside(*gpu_ranges[n], e["ts"]))
            if hit:
                in_range[n] += dur
    # the device's busy union, clipped to the slice, and its idle gaps
    spans = sorted((max(e["ts"], s0), min(e["ts"] + e.get("dur", 0), s1))
                   for e in dev)
    busy, gaps, cur = 0.0, [], s0
    for a, b in spans:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if s1 > cur:
        gaps.append((cur, s1))
    labels = _label_gaps(gaps, [e for e in host
                                if e.get("tid") == main_tid])
    idle: dict[str, float] = {}
    for (a, b), lab in zip(gaps, labels):
        idle[lab] = idle.get(lab, 0.0) + (b - a)

    def top(d):
        return [[k[:160], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"queries": queries, "slice_s": (s1 - s0) / 1e6,
            "busy_s": busy / 1e6, "kernels": kernels,
            "prf_s": in_range[PRF] / 1e6, "dense_s": in_range[DENSE] / 1e6,
            "depthwise_s": in_range[DEPTHWISE] / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(idle)}


def _label_gaps(gaps: list, host: list) -> list:
    """The innermost host operation running at each gap's midpoint (the
    gaps in time order), or ``host between operations`` where none runs
    inside the slice."""
    ev = sorted(host, key=lambda e: (e["ts"], -e.get("dur", 0)))
    out, stack, j = [], [], 0
    for a, b in gaps:
        m = (a + b) / 2
        while j < len(ev) and ev[j]["ts"] <= m:
            e = ev[j]
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < e["ts"]:
                stack.pop()
            stack.append(e)
            j += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < m:
            stack.pop()
        name = stack[-1]["name"] if stack else SLICE
        out.append("host between operations" if name == SLICE else name)
    return out
