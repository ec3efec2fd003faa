"""Secure serving: batched secure-BNN classifier inference end to end.

Port of ``repro/launch/serve_secure.py`` (``build``, ``make_runner`` with
``backend="local"`` and verification off, ``_serve_bnn`` with inline
offline material, the ``--deployment`` path solver, ``make_obs`` /
``emit_obs`` and the ``--trace`` / ``--metrics-json`` / ``--metrics-prom``
outputs; not ``--offline``, ``--verify`` or ``--model lm``).  The model
owner compiles once (BN folds, secret sharing or publication, cached
kernel operands, the cost model's path labels and the autotuner's kernel
configs); every query batch then runs the full CBNN protocol stack on the
device, its linear layers on the CUDA kernels: shared weights on the RSS
products (rss_matmul, grouped_rss_matmul), public weights on the local
public products (bin_rss_matmul, bin_grouped_matmul).  Every net of the
zoo is served, the ReLU teachers (MnistNet4, CifarNet7) included.  Runs on
the card unless ``--device cpu`` is given.  The round structure is an API
toggle, as in the reference (``repro_torch.core.linear.set_fused_rounds``),
not a flag.

  PYTHONPATH=src python -m repro_torch.launch.serve_secure --net CifarNet2 \
      --batch 32 --queries 4 [--weights shared|public] \
      [--binary-linear auto|generic|off] [--deployment local|lan|wan] \
      [--trace t.json] [--metrics-json m.json] [--metrics-prom m.prom] \
      [--device cpu] [--json PATH]

Prints q/s and img/s, the per-query online/offline rounds and bytes, the
cost model's prediction against the live ledger, and the launches of each
kernel; with an observability output also the per-layer
predicted-vs-measured attribution table and the time per phase.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import comm, cost_model, prf, telemetry
from ..core.randomness import Parties
from ..core.ring import RING32
from ..core.rss import RSS, share
from ..core.secure_model import (BINARY_LINEAR_MODES, WEIGHT_MODES,
                                 compile_secure, secure_infer)
from ..device import resolve_device
from ..kernels import build as kbuild
from ..nn.bnn import INPUT_SHAPES, init_bnn
from .profiling import print_profile, profile_once, sync

__all__ = ["build", "make_runner", "serve", "make_obs", "emit_obs", "main"]


def build(net: str, device=None, params=None, weights: str = "shared",
          binary_linear: str = "auto", deployment=None,
          autotune_cache=None):
    """Compile ``net`` for secure serving on the kernel route:
    ``init_bnn`` weights from seed 0 (or the given ``params``), shares
    from ``PRNGKey(1)``; ``weights`` / ``binary_linear`` / ``deployment``
    / ``autotune_cache`` as in ``compile_secure``."""
    device = resolve_device(device)
    if params is None:
        params = init_bnn(0, net, device=device)
    return compile_secure(params, net, prf.PRNGKey(1), RING32, device=device,
                          weights=weights, binary_linear=binary_linear,
                          deployment=deployment,
                          autotune_cache=autotune_cache)


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
          binary_linear: str = "auto", deployment=None, autotune_cache=None,
          tracer: telemetry.Tracer | None = None,
          registry: telemetry.MetricsRegistry | None = None) -> dict:
    """Build, compile, one warm-up query, then ``queries`` timed queries
    (and, with ``profile``, one profiled query after them).  ``x`` (float
    (B, H, W, C)) defaults to random ±0.5 pixels from ``seed``.
    ``deployment`` (a registry name or descriptor) is solved at
    ``batch``.  The cost model's prediction at ``batch`` must equal the
    warm-up query's live ledger, or this raises.

    ``tracer`` records the compile, warm-up and per-query spans (and, via
    the comm listener, every query's protocol ops); ``registry`` collects
    the query latency histogram and the movement counters over the timed
    queries only.  Returns the stats dict: logits under ``"logits"``, the
    warm-up query's ``"ledger"``, the ``"predicted"`` report and the
    ``"model"``."""
    if net not in INPUT_SHAPES:
        raise ValueError(f"unknown net {net!r}; available: "
                         + ", ".join(sorted(INPUT_SHAPES)))
    if batch < 1 or queries < 1:
        raise ValueError("batch and queries must be >= 1")
    device = resolve_device(device)
    shape = INPUT_SHAPES[net]
    dep = cost_model.resolve_deployment(deployment)
    if dep is not None:
        dep = dep.with_batch(batch)
    with telemetry.tracing(tracer):
        t0 = time.perf_counter()
        with telemetry.span("compile_secure", cat="compile", net=net,
                            batch=batch):
            model = build(net, device=device, params=params,
                          weights=weights, binary_linear=binary_linear,
                          deployment=dep, autotune_cache=autotune_cache)
            sync(device)
        compile_s = time.perf_counter() - t0
        pred = cost_model.model_cost(model, (batch,) + shape)
        parties = Parties.setup(prf.PRNGKey(seed + 7), device=device)
        if x is None:
            rng = np.random.default_rng(seed)
            x = rng.integers(0, 2, (batch,) + shape).astype(np.float32) - 0.5
        xs = share(torch.as_tensor(x, device=device), prf.PRNGKey(seed + 3),
                   RING32)
        run = make_runner(model)
        launches0 = dict(kbuild.LAUNCHES)
        with telemetry.span("warmup", cat="compile"), \
                comm.track() as led:     # the warm-up query's ledger
            out = run(parties.keys, xs.shares)
            sync(device)
        assert tuple(out.shape) == (batch, 10), out.shape
        if (pred.rounds, pred.nbytes, pred.pre_rounds, pred.pre_nbytes) != \
                (led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes):
            raise RuntimeError(
                f"cost-model prediction {pred.total} diverged from the "
                f"ledger {led.rounds} / {led.nbytes} online, "
                f"{led.pre_rounds} / {led.pre_nbytes} offline")
        t0 = time.perf_counter()
        if telemetry.enabled():
            with telemetry.collecting(registry):
                for q in range(queries):
                    with telemetry.span(f"query[{q}]", cat="online",
                                        lane="parties"):
                        tq = time.perf_counter()
                        out = run(parties.keys, xs.shares)
                        sync(device)
                        telemetry.observe("query_latency_seconds",
                                          time.perf_counter() - tq)
        else:
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
            "deployment": dep.name if dep is not None else None,
            "predicted_rounds": pred.rounds, "predicted_bytes": pred.nbytes,
            "logits": out.float().cpu().numpy(),
            "ledger": led, "predicted": pred, "model": model}


def make_obs(args, device=None):
    """``--trace`` / ``--metrics-*`` -> (Tracer | None, registry | None):
    both or neither.  The tracer times online spans with CUDA events on a
    CUDA ``device``."""
    if not (args.trace or args.metrics_json or args.metrics_prom):
        return None, None
    return (telemetry.Tracer(device=device), telemetry.MetricsRegistry())


def emit_obs(args, tracer, reg, led, predicted=None, model=None,
             online_s=None, queries=1, unit="query"):
    """Write the ``--trace`` / ``--metrics-*`` outputs and print the
    predicted-vs-measured attribution table.  Measured rounds and bytes
    per row come from the per-query ledger and sum to its totals exactly;
    the measured time (``online_s`` over ``queries``) is split by
    predicted time share.  The registry's comm counters are the ledger ×
    ``queries``."""
    if tracer is None and reg is None:
        return None
    if reg is not None:
        reg.record_ledger(led, model, queries=queries)
    per_q = online_s / queries if online_s and queries else None
    rep = telemetry.attribution(predicted, led, online_s=per_q,
                                deployment=args.deployment)
    print(f"[serve_secure] attribution per {unit} "
          f"(deployment={rep.deployment}, "
          f"{'prediction exact' if rep.exact else 'prediction DIVERGED'}):")
    print(rep.render())
    if tracer is not None:
        print("[serve_secure] phases: "
              + "  ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                          sorted(tracer.phase_seconds().items())))
        if args.trace:
            tracer.write(args.trace)
            print(f"[serve_secure] wrote trace {args.trace} "
                  f"({len(tracer.spans)} spans; open in Perfetto or "
                  "chrome://tracing)")
    if args.metrics_json:
        reg.write_json(args.metrics_json)
        print(f"[serve_secure] wrote metrics {args.metrics_json}")
    if args.metrics_prom:
        reg.write_prom(args.metrics_prom)
        print(f"[serve_secure] wrote metrics {args.metrics_prom}")
    return rep


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
    ap.add_argument("--deployment", default=None, metavar="NAME",
                    help="deployment the protocol-path solver optimises "
                         "for (DESIGN.md §15): local, lan or wan; default "
                         "keeps the lexicographic (bytes, rounds) order")
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more query: device time by kernel")
    obs = ap.add_argument_group("observability (DESIGN.md §17)")
    obs.add_argument("--trace", default="", metavar="PATH",
                     help="write a Chrome trace-event JSON of the run "
                          "(compile / warm-up / query spans with per-op "
                          "comm annotations, device time of each query; "
                          "open in Perfetto or chrome://tracing)")
    obs.add_argument("--metrics-json", default="", metavar="PATH",
                     help="write the metrics registry (comm counters, "
                          "latency histogram with p50/p95/p99, movement "
                          "counters) as JSON")
    obs.add_argument("--metrics-prom", default="", metavar="PATH",
                     help="write the same metrics in Prometheus text "
                          "exposition format")
    args = ap.parse_args(argv)
    if args.deployment is not None \
            and args.deployment.lower() not in cost_model.DEPLOYMENTS:
        ap.error(f"unknown --deployment {args.deployment!r}; available: "
                 + ", ".join(sorted(cost_model.DEPLOYMENTS)))
    tracer, reg = make_obs(args, resolve_device(args.device))
    st = serve(args.net, args.batch, args.queries, args.device, args.seed,
               profile=args.profile, weights=args.weights,
               binary_linear=args.binary_linear, deployment=args.deployment,
               tracer=tracer, registry=reg)
    model, pred, led = st["model"], st["predicted"], st["ledger"]
    if args.deployment is not None:
        print(f"[serve_secure] path solver ({st['deployment']}): "
              + ", ".join(f"{e.name}={e.path}"
                          for e in model.predicted.entries
                          if e.name.startswith("l")))
        dep = cost_model.resolve_deployment(args.deployment) \
            .with_batch(args.batch)
        print(f"[serve_secure] predicted online: {pred.rounds} rounds, "
              f"{pred.nbytes / 1e6:.3f} MB, "
              f"{pred.time(dep) * 1e3:.1f} ms/query")
    print(f"[serve_secure] cost model: predicted {pred.rounds} rounds / "
          f"{pred.nbytes:,} B vs measured {led.rounds} / {led.nbytes:,} B "
          f"-> exact")
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
    st["attribution"] = emit_obs(args, tracer, reg, led, predicted=pred,
                                 model=model, online_s=st["seconds"],
                                 queries=st["queries"])
    if args.json:
        stats = {k: v for k, v in st.items()
                 if k not in ("logits", "ledger", "predicted", "model",
                              "attribution")}
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"[serve_secure] wrote {args.json}")
    return st


if __name__ == "__main__":
    main()
