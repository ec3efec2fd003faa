"""Secure serving: batched secure-BNN classifier inference end to end.

Port of ``repro/launch/serve_secure.py`` (``build``, ``make_runner`` with
``backend="local"`` and verification off, ``_serve_bnn`` with inline
offline material, no deployment solver, no trace).  The model owner
compiles once (BN folds, secret sharing or publication, cached kernel
operands); every query batch then runs the full CBNN protocol stack on the
device, its linear layers on the CUDA kernels: shared weights on the RSS
products (rss_matmul, grouped_rss_matmul), public weights on the local
public products (bin_rss_matmul, bin_grouped_matmul).  Every net of the
zoo is served, the ReLU teachers (MnistNet4, CifarNet7) included.  Runs on
the card unless ``--device cpu`` is given.  The round structure is an API
toggle, as in the reference (``repro_torch.core.linear.set_fused_rounds``),
not a flag.

  PYTHONPATH=src python -m repro_torch.launch.serve_secure --net CifarNet2 \
      --batch 32 --queries 4 [--weights shared|public] \
      [--binary-linear auto|generic|off] [--device cpu] [--json PATH]

Prints q/s and img/s, the per-query online/offline rounds and bytes, and
the launches of each kernel.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import comm, prf
from ..core.randomness import Parties
from ..core.ring import RING32
from ..core.rss import RSS, share
from ..core.secure_model import (BINARY_LINEAR_MODES, WEIGHT_MODES,
                                 compile_secure, secure_infer)
from ..device import resolve_device
from ..kernels import build as kbuild
from ..nn.bnn import INPUT_SHAPES, init_bnn
from .profiling import print_profile, profile_once, sync

__all__ = ["build", "make_runner", "serve", "main"]


def build(net: str, device=None, params=None, weights: str = "shared",
          binary_linear: str = "auto"):
    """Compile ``net`` for secure serving on the kernel route:
    ``init_bnn`` weights from seed 0 (or the given ``params``), shares
    from ``PRNGKey(1)``; ``weights`` / ``binary_linear`` as in
    ``compile_secure``."""
    device = resolve_device(device)
    if params is None:
        params = init_bnn(0, net, device=device)
    return compile_secure(params, net, prf.PRNGKey(1), RING32, device=device,
                          weights=weights, binary_linear=binary_linear)


def make_runner(model):
    """Runner ``fn(keys, x_stack) -> (B, classes)`` opened logits, on the
    local (stacked) transport, the port's only one so far."""

    def run(keys, x_stack):
        return secure_infer(model, RSS(x_stack, model.ring),
                            Parties(keys, device=x_stack.device))
    return run


def serve(net: str = "MnistNet1", batch: int = 32, queries: int = 4,
          device=None, seed: int = 0, params=None, x=None,
          profile: bool = False, weights: str = "shared",
          binary_linear: str = "auto") -> dict:
    """Build, compile, one warm-up query, then ``queries`` timed queries
    (and, with ``profile``, one profiled query after them).  ``x`` (float
    (B, H, W, C)) defaults to random ±0.5 pixels from ``seed``.  Returns
    the stats dict (logits under ``"logits"``)."""
    if net not in INPUT_SHAPES:
        raise ValueError(f"unknown net {net!r}; available: "
                         + ", ".join(sorted(INPUT_SHAPES)))
    if batch < 1 or queries < 1:
        raise ValueError("batch and queries must be >= 1")
    device = resolve_device(device)
    shape = INPUT_SHAPES[net]
    t0 = time.perf_counter()
    model = build(net, device=device, params=params, weights=weights,
                  binary_linear=binary_linear)
    sync(device)
    compile_s = time.perf_counter() - t0
    parties = Parties.setup(prf.PRNGKey(seed + 7), device=device)
    if x is None:
        rng = np.random.default_rng(seed)
        x = rng.integers(0, 2, (batch,) + shape).astype(np.float32) - 0.5
    xs = share(torch.as_tensor(x, device=device), prf.PRNGKey(seed + 3),
               RING32)
    run = make_runner(model)
    launches0 = dict(kbuild.LAUNCHES)
    with comm.track() as led:            # the warm-up query's ledger
        out = run(parties.keys, xs.shares)
    sync(device)
    assert tuple(out.shape) == (batch, 10), out.shape
    t0 = time.perf_counter()
    for _ in range(queries):
        out = run(parties.keys, xs.shares)
    sync(device)
    dt = time.perf_counter() - t0
    qps = queries / dt
    per_query = {k: (v - launches0[k]) // (queries + 1)
                 for k, v in kbuild.LAUNCHES.items()}
    prof = (profile_once(lambda: run(parties.keys, xs.shares), device,
                         dt / queries) if profile else None)
    return {"profile": prof, "net": net, "weights": weights,
            "binary_linear": binary_linear, "batch": batch,
            "queries": queries,
            "device": str(device),
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "compile_s": compile_s, "seconds": dt,
            "query_per_s": qps, "img_per_s": qps * batch,
            "online_rounds": led.rounds, "online_bytes": led.nbytes,
            "offline_rounds": led.pre_rounds, "offline_bytes": led.pre_nbytes,
            "launches_per_query": per_query,
            "logits": out.float().cpu().numpy()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--net", default="MnistNet1")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", default="shared", choices=WEIGHT_MODES,
                    help="secret-shared or public model weights")
    ap.add_argument("--binary-linear", default="auto",
                    choices=BINARY_LINEAR_MODES,
                    help="post-Sign routing: binary engine, generic Alg-2 "
                         "reference (shared weights only), or off")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more query: device time by kernel")
    args = ap.parse_args(argv)
    st = serve(args.net, args.batch, args.queries, args.device, args.seed,
               profile=args.profile, weights=args.weights,
               binary_linear=args.binary_linear)
    print(f"[serve_secure] {st['net']} weights={st['weights']} "
          f"binary_linear={st['binary_linear']} device={st['device']} "
          f"({st['kind']}) batch={st['batch']}: {st['queries']} queries in "
          f"{st['seconds']:.4f}s = {st['query_per_s']:.3f} q/s "
          f"({st['img_per_s']:.1f} img/s)")
    print(f"[serve_secure] per-query comm: {st['online_bytes']:,} B online "
          f"({st['online_rounds']} rounds) + {st['offline_bytes']:,} B "
          f"offline ({st['offline_rounds']} rounds)")
    print("[serve_secure] kernel launches per query: "
          + ", ".join(f"{k}={v}" for k, v in st["launches_per_query"].items()))
    if st["profile"] is not None:
        print_profile("serve_secure", "query", st["profile"])
    if args.json:
        stats = {k: v for k, v in st.items() if k != "logits"}
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"[serve_secure] wrote {args.json}")
    return st


if __name__ == "__main__":
    main()
