"""Kernel autotuner over the CUDA kernels' own launch choices (DESIGN.md §15).

Port of ``repro/kernels/autotune.py`` (``cache_key``, ``load_cache``,
``_save_cache``, ``lookup``, ``candidate_space``, ``autotune``,
``ensure_tuned``, the ``--smoke`` CLI, the JSON format with ``us`` /
``default_us``).  The reference searches Pallas block sizes and a
Pallas-or-XLA lowering; the port searches what its CUDA kernels can choose
(``lowering.KernelConfig``): B1's and B3's route (int8 tensor cores over
the limbs, or the CUDA cores), the tensor-core route's split-K count, and
B3's CUDA-core tile width.  Each candidate is timed on live data and the
winner persists in a JSON cache that ``compile_secure`` reads at model
setup, pinning it on each op as ``op["kcfg"]``.

Every candidate computes the same words mod 2^32 (split-K blocks add with
int32 atomics, which are order-free), so tuning changes times, never
results; :func:`autotune` checks each candidate's output against the
plan's, bit for bit, before it times it.  **On the card the plain PyTorch
version is never a candidate**: the kernel is the only route there, and a
kernel that fails to build or launch raises.  On the CPU the plain version
is the only lowering, so the space is that one config.  The grouped
kernels (B2, B4) have one candidate: their time is recorded.

Cache format (JSON; ``build/repro_torch/autotune.json`` at the checkout's
root, ``$REPRO_TORCH_AUTOTUNE_CACHE``, or an explicit path)::

    {"version": 1,
     "entries": {
       "rss_matmul.m128k896n128.L4.NVIDIA H100 80GB HBM3": {
           "route": "tensor-core", "splits": 7, "bn": null,
           "us": ..., "default_us": ..., "space": "smoke"},
       ...}}

Keys are ``<family>.m<Mp>k<Kp>n<Np>[.c<C>].L<limbs>.<device>``: the dims
padded to 128 as the kernels pad their weight caches (grouped: M only),
ending in the card's name (``torch.cuda.get_device_name``) or ``cpu``.
Times are medians after warm-up: CUDA events around each launch on the
card (the host's clock on the CPU).

    python -m repro_torch.kernels.autotune --smoke [--cache P] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from pathlib import Path
from typing import Iterable, Sequence

import torch

from . import build
from .bin_rss_matmul import (_launch_bin, bin_grouped_matmul_parts,
                             bin_rss_matmul_parts, grouped_rss_matmul_parts,
                             grouped_weight_limbs, public_grouped_limbs,
                             public_weight_limbs)
from .limbs import CUDA_CORE, K_STAGE, TENSOR_CORE, sm_count
from .lowering import (BN_CHOICES, DEFAULT_CONFIG, PLAIN, KernelConfig,
                       bn_for, normalize, plan_config)
from .rss_matmul import _launch, precompute_weight_limbs, rss_matmul_parts

__all__ = ["KernelConfig", "DEFAULT_CONFIG", "FAMILIES", "default_cache_path",
           "load_cache", "lookup", "candidate_space", "autotune",
           "ensure_tuned", "cache_key", "device_name"]

_TILE = 128
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1

FAMILIES = ("rss_matmul", "bin_rss_matmul",
            "grouped_rss_matmul", "bin_grouped_matmul")
_GROUPED = ("grouped_rss_matmul", "bin_grouped_matmul")
_SLOTS = 3      # the local transport's share stack


def default_cache_path() -> Path:
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return build.BUILD_DIR / "autotune.json"


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_name(device=None) -> str:
    """The key's last field: the card's name, or ``cpu``."""
    dev = _device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _pad(d: int) -> int:
    return d + (-d) % _TILE


def cache_key(family: str, m: int, k: int, n: int, *, n_limbs: int = 4,
              channels: int | None = None, device=None) -> str:
    """Cache key of a logical (family, shape, limbs, device) launch."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}")
    name = device_name(device)
    if family in _GROUPED:
        return (f"{family}.m{_pad(m)}k{k}n{n}.c{channels or 1}"
                f".L{n_limbs}.{name}")
    return f"{family}.m{_pad(m)}k{_pad(k)}n{_pad(n)}.L{n_limbs}.{name}"


# ---------------------------------------------------------------------------
# Cache IO
# ---------------------------------------------------------------------------

_CACHE_MEM: dict[str, dict] = {}


def load_cache(path: Path | str | None = None, *,
               refresh: bool = False) -> dict:
    """Load (and memoize) the entry dict of a cache file; {} if absent."""
    p = Path(path) if path is not None else default_cache_path()
    key = str(p)
    if not refresh and key in _CACHE_MEM:
        return _CACHE_MEM[key]
    entries: dict = {}
    if p.exists():
        try:
            data = json.loads(p.read_text())
            if isinstance(data, dict):
                entries = data.get("entries", {})
        except (json.JSONDecodeError, OSError, UnicodeDecodeError):
            entries = {}  # a corrupt cache is a cold cache, never fatal
    _CACHE_MEM[key] = entries
    return entries


def _save_cache(entries: dict, path: Path | str | None = None) -> Path:
    p = Path(path) if path is not None else default_cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"version": CACHE_VERSION,
                             "entries": dict(sorted(entries.items()))},
                            indent=1))
    _CACHE_MEM[str(p)] = entries
    return p


def _config(entry: dict) -> KernelConfig:
    return KernelConfig(route=entry.get("route"), splits=entry.get("splits"),
                        bn=entry.get("bn"))


def lookup(family: str, m: int, k: int, n: int, *, n_limbs: int = 4,
           channels: int | None = None, path: Path | str | None = None,
           device=None) -> KernelConfig | None:
    """Best known config of a launch, or None on a miss (the caller then
    runs the plan, ``DEFAULT_CONFIG``)."""
    entry = load_cache(path).get(cache_key(
        family, m, k, n, n_limbs=n_limbs, channels=channels, device=device))
    return _config(entry) if entry else None


# ---------------------------------------------------------------------------
# Candidate space + timing
# ---------------------------------------------------------------------------

def candidate_space(family: str, m: int, k: int, n: int, *,
                    smoke: bool = False, device=None,
                    sms: int | None = None) -> list[KernelConfig]:
    """Search space of one launch, the plan's config first.

    On the CPU: the plain version, alone.  Grouped families: the kernel,
    alone.  B1 / B3 on the card: the plan, the other route, and split-K
    counts around the plan's (half and double it, one split; without
    ``smoke`` also every power of two up to the K stages); B3's CUDA-core
    route at every tile width where the plan takes it (``smoke``) or
    always."""
    dev = _device(device)
    if dev.type != "cuda":
        return [KernelConfig(route=PLAIN)]
    if family in _GROUPED:
        return [DEFAULT_CONFIG]
    if sms is None:
        sms = sm_count(dev)
    plan = plan_config(family, _SLOTS, m, k, n, sms)
    steps = -(-k // K_STAGE)
    splits = {1, max(1, plan.splits // 2), plan.splits * 2}
    if not smoke:
        splits |= {1 << i for i in range(steps.bit_length() + 1)}
    cands = [plan] + [KernelConfig(TENSOR_CORE, s) for s in sorted(splits)
                      if s <= steps]
    if family != "bin_rss_matmul":
        widths = (None,)
    elif smoke and plan.route != CUDA_CORE:
        widths = (bn_for(n),)
    else:
        widths = BN_CHOICES
    cands += [KernelConfig(CUDA_CORE, 1, bn) for bn in widths]
    seen, uniq = set(), []
    for c in (normalize(c, k) for c in cands):
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


def _time_us(fn, device: torch.device, iters: int) -> float:
    """Median microseconds of one call after warm-up: CUDA events around
    each launch on the card (a spin kernel holds the stream while the host
    enqueues them, so host overhead stays out), the host clock on CPU."""
    iters = max(1, iters)
    for _ in range(2):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e6
    torch.cuda.synchronize(device)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(20_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize(device)
    return statistics.median(a.elapsed_time(b) for a, b in ev) * 1e3


def _operands(family: str, m: int, k: int, n: int, *, n_limbs: int,
              channels: int | None, device: torch.device):
    """``run(cfg)`` on random operands of one family: shares uniform mod
    2^32, public encodings bounded to the requested limb count."""
    g = torch.Generator(device=device).manual_seed(0)

    def words(*shape, bound=None):
        lo, hi = (-2**31, 2**31) if bound is None else (-bound, bound)
        return torch.randint(lo, hi, shape, dtype=torch.int32, device=device,
                             generator=g)

    bound = None if n_limbs == 4 else 1 << (8 * n_limbs - 2)
    on_card = device.type == "cuda"
    if family == "rss_matmul":
        x, w = words(_SLOTS, m, k), precompute_weight_limbs(
            words(_SLOTS, k, n))
        return lambda cfg: (_launch(x, w, cfg) if on_card
                            else rss_matmul_parts(x, w))
    if family == "bin_rss_matmul":
        x = words(_SLOTS, m, k)
        w = public_weight_limbs(words(k, n, bound=bound), n_limbs)
        return lambda cfg: (_launch_bin(x, w, cfg) if on_card
                            else bin_rss_matmul_parts(x, w))
    c = channels or 1
    # the secure path's layout: an (S, M, K, C) buffer viewed (S, C, M, K)
    x = words(_SLOTS, m, k, c).permute(0, 3, 1, 2)
    if family == "grouped_rss_matmul":
        w = grouped_weight_limbs(words(_SLOTS, c, k, n))
        return lambda cfg: grouped_rss_matmul_parts(x, w)
    if family == "bin_grouped_matmul":
        w = public_grouped_limbs(words(c, k, n, bound=bound), n_limbs)
        return lambda cfg: bin_grouped_matmul_parts(x, w)
    raise ValueError(f"unknown kernel family {family!r}")


def autotune(family: str, m: int, k: int, n: int, *, n_limbs: int = 4,
             channels: int | None = None, iters: int = 20,
             smoke: bool = False, cache_path: Path | str | None = None,
             force: bool = False, device=None
             ) -> tuple[KernelConfig, dict[KernelConfig, float]]:
    """Time every candidate of one launch, persist and return the winner.

    Returns ``(best, {config: microseconds})``.  A cached result returns
    without timing unless ``force``.  Each candidate's output must equal
    the plan's (the first candidate's) bit for bit, or this raises.  The
    entry records ``us`` (the winner) and ``default_us`` (the plan)."""
    dev = _device(device)
    key = cache_key(family, m, k, n, n_limbs=n_limbs, channels=channels,
                    device=dev)
    entries = load_cache(cache_path)
    if not force and key in entries:
        e = entries[key]
        cfg = _config(e)
        return cfg, {cfg: float(e["us"]),
                     DEFAULT_CONFIG: float(e.get("default_us", e["us"]))}
    run = _operands(family, m, k, n, n_limbs=n_limbs, channels=channels,
                    device=dev)
    cands = candidate_space(family, m, k, n, smoke=smoke, device=dev)
    want = run(cands[0])
    timings: dict[KernelConfig, float] = {}
    for cfg in cands:
        if not torch.equal(run(cfg), want):
            raise RuntimeError(f"autotune {key}: {cfg.describe()} differs "
                               f"from {cands[0].describe()}")
        timings[cfg] = _time_us(lambda cfg=cfg: run(cfg), dev, iters)
    best = min(timings, key=timings.get)
    entries[key] = {**best._asdict(), "us": round(timings[best], 3),
                    "default_us": round(timings[cands[0]], 3),
                    "space": "smoke" if smoke else "full"}
    _save_cache(entries, cache_path)
    return best, timings


def ensure_tuned(requests: Iterable[Sequence], *, iters: int = 20,
                 smoke: bool = True, cache_path: Path | str | None = None,
                 device=None, on_tuned=None) -> int:
    """Tune every launch of ``requests`` that misses the cache, each
    distinct key once.  A request is ``(family, m, k, n, n_limbs,
    channels)``, as ``core.cost_model``'s ``kernel_requests`` lists them;
    ``on_tuned(request, best, timings)`` sees each launch timed.  Returns
    the number of launches timed."""
    tuned = 0
    done: set[str] = set()
    for family, m, k, n, n_limbs, channels in requests:
        key = cache_key(family, m, k, n, n_limbs=n_limbs, channels=channels,
                        device=device)
        if key in done:
            continue
        done.add(key)
        if lookup(family, m, k, n, n_limbs=n_limbs, channels=channels,
                  path=cache_path, device=device) is None:
            best, timings = autotune(
                family, m, k, n, n_limbs=n_limbs, channels=channels,
                iters=iters, smoke=smoke, cache_path=cache_path,
                device=device)
            if on_tuned is not None:
                on_tuned((family, m, k, n, n_limbs, channels), best, timings)
            tuned += 1
    return tuned


# ---------------------------------------------------------------------------
# CLI: the bounded smoke entry point
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Autotune the launch choices of the RSS matmul kernels")
    ap.add_argument("--smoke", action="store_true",
                    help="bounded candidate space")
    ap.add_argument("--cache", default=None,
                    help=f"cache JSON path (default: ${CACHE_ENV} or "
                         f"{default_cache_path()})")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--force", action="store_true",
                    help="re-time even on a cache hit")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    dev = resolve_device(args.device)
    shapes = [("rss_matmul", args.m, args.k, args.n, 4, None),
              ("bin_rss_matmul", args.m, args.k, args.n, 3, None),
              ("grouped_rss_matmul", args.m, 9, 1, 4, 16),
              ("bin_grouped_matmul", args.m, 9, 1, 1, 16)]
    for family, m, k, n, n_limbs, channels in shapes:
        best, timings = autotune(
            family, m, k, n, n_limbs=n_limbs, channels=channels,
            iters=args.iters, smoke=args.smoke, cache_path=args.cache,
            force=args.force, device=dev)
        key = cache_key(family, m, k, n, n_limbs=n_limbs, channels=channels,
                        device=dev)
        print(f"[autotune] {key}")
        for cfg, us in sorted(timings.items(), key=lambda kv: kv[1]):
            mark = " <- best" if cfg == best else ""
            print(f"    {cfg.describe():<32} {us:12.3f} us{mark}")
    path = Path(args.cache) if args.cache else default_cache_path()
    print(f"[autotune] cache: {path} ({len(load_cache(path))} entries)")


if __name__ == "__main__":
    main()
