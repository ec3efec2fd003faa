"""Secure serving: batched secure-BNN classifier inference and secure LM
decode, end to end.

Port of ``repro/launch/serve_secure.py`` on both backends,
``--backend local|mesh``, each serving the classifiers and the LM
(``build``, ``make_runner`` and ``make_tape_runner`` with ``verify``,
``serve_pool``, ``_serve_bnn`` with ``--offline inline|pool``,
``--pool-depth`` and ``--verify off|opens|full``, the ``--deployment``
path solver, ``make_obs`` / ``emit_obs`` and the ``--trace`` /
``--metrics-json`` / ``--metrics-prom`` outputs, and ``--model lm``:
``_serve_lm`` with ``--lm-d/heads/ffn/blocks/vocab``, ``--prompt``,
``--gen``, ``--buckets``, ``--softmax-attention``, ``--static-norm`` and
``--quick``).  ``--backend local`` runs the three parties stacked in one
process; ``--backend mesh`` runs each party in a process of its own
(core/party_group.py) that exchanges every message over
``MeshTransport``.  The model owner compiles once (BN folds, secret
sharing or publication, cached kernel operands, the cost model's path
labels and the autotuner's kernel configs); every query batch then runs
the full CBNN protocol stack on the device, its linear layers on the CUDA
kernels: shared weights on the RSS products (rss_matmul,
grouped_rss_matmul), public weights on the local public products
(bin_rss_matmul, bin_grouped_matmul).  Every net of the zoo is served,
the ReLU teachers (MnistNet4, CifarNet7) included.  Runs on the card
unless ``--device cpu`` is given.  The round structure is an API toggle,
as in the reference (``repro_torch.core.linear.set_fused_rounds``), not a
flag.

``--offline pool`` traces the model's MaterialSpec once and serves every
query from a demand-gated pool of ``--pool-depth`` K tape slices
generated ahead of need (core/preprocessing.py): the online query
evaluates no PRF and records only the ledger's online rows.  ``--verify
opens`` cross-checks every opened value across the parties' views with
one deferred digest exchange a query; ``full`` also checks every reshare
and send, the ingested model shares and every consumed tape slice
(core/integrity.py).  A detected deviation aborts with exit code 3 after
flushing the trace and metrics.

  PYTHONPATH=src python -m repro_torch.launch.serve_secure --net CifarNet2 \
      --batch 32 --queries 4 [--weights shared|public] \
      [--binary-linear auto|generic|off] [--deployment local|lan|wan] \
      [--offline inline|pool] [--pool-depth K] [--verify off|opens|full] \
      [--trace t.json] [--metrics-json m.json] [--metrics-prom m.prom] \
      [--device cpu] [--json PATH]

Prints q/s and img/s (under ``pool`` online-only and amortised), the
per-query online/offline rounds and bytes, the cost model's prediction
against the live ledger, and the launches of each kernel; with an
observability output also the per-layer predicted-vs-measured attribution
table and the time per phase.

``--model lm`` serves the secure decoder LM of ``core/secure_transformer.py``
(the reference's deterministic weights, ``share_lm_params``): a secure
prefill of a random prompt, then a greedy decode loop whose step is built
once per padded bucket length (the smallest of ``--buckets`` that holds
prompt + gen); a warm-up generation, then ``--queries`` timed ones.  It
prints tok/s, the online KB and rounds a token (one step's live ledger,
held byte-exact to ``cost_model.lm_step_cost``: a mismatch raises) and the
kernel launches a token; ``--quick`` (d 16, 2 heads, 1 block, static norm)
also holds the greedy tokens to the fp32 oracle's.

  PYTHONPATH=src python -m repro_torch.launch.serve_secure --model lm \
      --lm-d 2048 --lm-heads 32 --lm-ffn 5632 --lm-vocab 32000 \
      --lm-blocks 12 --prompt 8 --gen 8 --buckets 16,64 --queries 2
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core import comm, cost_model, integrity, prf, telemetry
from ..core.preprocessing import (TapePool, make_tape_generator,
                                  make_tape_infer, trace_material)
from ..core.party_group import PartyGroup
from ..core.randomness import Parties
from ..core.ring import RING32
from ..core.rss import RSS, share
from ..core.secure_model import (BINARY_LINEAR_MODES, WEIGHT_MODES,
                                 compile_secure, make_secure_infer_mesh,
                                 secure_infer)
from ..core.secure_transformer import (CompiledDecodeStep, SecureKVCache,
                                       init_kv_cache, make_secure_lm_mesh,
                                       plaintext_lm_forward, scan_prefill,
                                       secure_decode_step, share_lm_params)
from ..device import resolve_device
from ..kernels import build as kbuild
from ..nn.bnn import INPUT_SHAPES, init_bnn
from .profiling import print_profile, profile_once, sync

__all__ = ["build", "make_runner", "make_tape_runner", "serve_pool",
           "serve", "serve_lm", "make_obs", "emit_obs", "main",
           "OFFLINE_MODES", "BACKENDS"]

OFFLINE_MODES = ("inline", "pool")
BACKENDS = ("local", "mesh")
# --quick: the reference's CI preset (static norm, one block)
QUICK_LM = dict(d=16, heads=2, d_ff=32, blocks=1, vocab=16, prompt_len=3,
                gen=5, buckets=(8,))


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


def make_runner(model, verify: str = "off"):
    """Runner ``fn(keys, x_stack) -> (B, classes)`` opened logits on the
    local (stacked) transport.  ``verify`` ("opens" / "full") runs each
    query in a verify scope and checks its digest report on the host
    before the logits are released, raising
    :class:`~repro_torch.core.integrity.IntegrityError` on a deviation;
    the verifier is ``fn.verifier`` (``None`` when off)."""
    v = None if verify == "off" else integrity.Verifier(verify)

    def run(keys, x_stack):
        return _verified(v, lambda: secure_infer(
            model, RSS(x_stack, model.ring),
            Parties(keys, device=x_stack.device)))
    run.verifier = v
    return run


def make_tape_runner(model, spec, verify: str = "off"):
    """The online phase on a MaterialTape (DESIGN.md §12):
    ``fn(keys, x_stack, slabs) -> logits`` consuming one tape slice, with
    no PRF evaluation; ``verify`` as in :func:`make_runner`."""
    v = None if verify == "off" else integrity.Verifier(verify)
    base = make_tape_infer(model, spec)

    def run(keys, x_stack, slabs):
        return _verified(v, lambda: base(keys, x_stack, slabs))
    run.verifier = v
    return run


def _verified(v, query):
    """``query()`` under ``v``'s scope, its report checked after it."""
    if v is None:
        return query()
    with integrity.verify_scope(v):
        out = query()
        rep = v.traced_report()
    v.check(rep)
    return out


def serve_pool(run, gen, spec, keys, xs_shares, queries: int, depth: int,
               master_key, verify: str = "off", device=None,
               registry=None, spare: int = 0) -> dict:
    """Serve ``queries`` batches from a demand-gated :class:`TapePool`:
    ``ceil((queries + 1 + spare) / depth)`` buffers (the warm-up consumes
    one slice, ``spare`` more stay for the caller), the next generated as
    one drains.  Each slice is taken, and the device synchronised, before
    the online clock starts, so no plant work is inside the online time.
    The plant's buffers are timed too (host clock between synchronised
    points), so the amortised time charges each timed query its online
    time plus its share of every buffer: the loop's wall time would leave
    out the two buffers generated before it.  ``registry`` is installed
    around everything but the warm-up query: the pool's refill,
    backpressure and supply metrics, the timed queries' latencies and
    movements, and the plant's movements.  Returns the warm-up query's
    ledger, the last logits, the online-only, plant and amortised
    seconds, the refills and the pool."""
    if queries < 1:
        raise ValueError(f"queries must be >= 1, got {queries}")
    device = resolve_device(device)
    plant_s = 0.0

    def timed_gen(keys_stack):
        nonlocal plant_s
        sync(device)
        t = time.perf_counter()
        slabs = gen(keys_stack)
        sync(device)
        plant_s += time.perf_counter() - t
        return slabs

    with telemetry.collecting(registry):
        pool = TapePool(timed_gen, spec, depth, master_key,
                        demand=queries + 1 + spare, verify=verify == "full")
        sl = pool.take()
    sync(device)
    with telemetry.span("warmup", cat="compile"), comm.track() as led:
        out = run(keys, xs_shares, sl)
        sync(device)
    online_s = 0.0
    with telemetry.collecting(registry):
        for q in range(queries):
            sl = pool.take()
            sync(device)            # plant work done before the clock
            tq = time.perf_counter()
            with telemetry.span(f"query[{q}]", cat="online",
                                lane="parties"):
                out = run(keys, xs_shares, sl)
                sync(device)
            dq = time.perf_counter() - tq
            online_s += dq
            telemetry.observe("query_latency_seconds", dq)
    per_slice = plant_s / (pool.generated * depth)
    return {"ledger": led, "logits": out, "online_s": online_s,
            "plant_s": plant_s, "amortised_s": online_s + queries * per_slice,
            "refills": pool.refills, "pool": pool}


def mesh_data(batch: int, ranks: int, verify: str = "off",
              offline: str = "inline") -> int:
    """The data shards of a mesh run on ``ranks`` ranks: the largest
    d <= ranks / 3 that divides the batch (the reference's serving rule),
    and 1 under a verifier or the tape pool (both run party-only)."""
    if verify != "off" or offline == "pool":
        return 1
    return max(d for d in range(1, ranks // 3 + 1) if batch % d == 0)


def _mesh_queries(model, spec, parties, xs, queries: int, depth: int,
                  verify: str, device, group, master_key, registry=None,
                  profile: bool = False, data: int = 1) -> dict:
    """``--backend mesh``: one warm-up query, then ``queries`` timed ones,
    each party's program in its own process of ``group``
    (core/party_group.py).  The dealer stages each query (the ranks'
    input pairs, and under the pool their tape slices) before the clock;
    the online time is the slowest rank's, from a barrier to its last
    query's device completion.  Under the pool the plant runs here, timed
    as in :func:`serve_pool`.  Returns the warm-up query's ledger (rank
    0's), the last logits, the times, every rank's per-query wire counts
    and launches, the pool and the verifier.  With ``data`` shards the
    ledger is a shard's (rank 0's) and the logits every shard's."""
    verifier = None if verify == "off" else integrity.Verifier(verify)
    run = make_secure_infer_mesh(model, group, tape_spec=spec,
                                 verifier=verifier, data=data)
    plant_s = 0.0
    pool = None
    if spec is not None:
        gen = make_tape_generator(spec, device)

        def timed_gen(keys_stack):
            nonlocal plant_s
            sync(device)
            t = time.perf_counter()
            slabs = gen(keys_stack)
            sync(device)
            plant_s += time.perf_counter() - t
            return slabs

        with telemetry.collecting(registry):
            pool = TapePool(timed_gen, spec, depth, master_key,
                            demand=queries + 1, verify=verify == "full")

    def staged(n):
        return [run.prepare(xs.shares, pool.take() if pool else None)
                for _ in range(n)]

    try:
        with telemetry.span("warmup", cat="compile"):
            warm = run.run(parties.keys, staged(1))
        led = comm.CommLedger.from_dict(warm["ranks"][0]["queries"][0]
                                        ["ledger"])
        prepared = staged(queries)
        t0 = time.perf_counter()
        with telemetry.span(f"queries[{queries}]", cat="online",
                            lane="parties"):
            timed = run.run(parties.keys, prepared)
        wall_s = time.perf_counter() - t0
        prof = (run.run(parties.keys, prepared[-1:], profile=True)
                if profile else None)
    finally:
        run.close()
    ranks = timed["ranks"]
    tr = telemetry.tracer()
    for r, rk in enumerate(ranks):
        for q, rec in enumerate(rk["queries"]):
            w = rec["wire"]
            if tr is not None:
                tr.spans.append(telemetry.Span(
                    f"query[{q}]", "online", rec["start"], rec["seconds"],
                    lane=(f"party{r}" if data == 1
                          else f"party{r % 3}.shard{r // 3}"),
                    args={"wire_bytes": w["nbytes"],
                          "messages": w["messages"],
                          "staging_ms": w["staging_s"] * 1e3}))
            if registry is not None:
                registry.observe("query_latency_seconds", rec["seconds"],
                                 party=str(r))
    online_s = max(rk["seconds"] for rk in ranks)
    per_slice = plant_s / (pool.generated * depth) if pool else 0.0
    # each rank's launches as it counted them: warm-up, timed, profiled
    launches = [{} for _ in ranks]
    runs = (warm, timed) + ((prof,) if prof else ())
    for res in runs:
        for r in range(len(ranks)):
            for k, c in res["ranks"][r]["launches"].items():
                launches[r][k] = launches[r].get(k, 0) + c
    return {"ledger": led, "logits": timed["out"], "online_s": online_s,
            "wall_s": wall_s, "plant_s": plant_s,
            "amortised_s": online_s + queries * per_slice,
            "refills": pool.refills if pool else 0, "pool": pool,
            "verifier": verifier, "ranks": ranks, "rank_launches": launches,
            "data": data,
            "runs": sum(len(res["ranks"][0]["queries"]) for res in runs),
            "profile": ([rk["profile"] for rk in prof["ranks"]] if prof
                        else None)}


def _mesh_stats(ms: dict, led) -> dict:
    """The per-rank wire against the ledger (its ``verify.digest`` row
    left out: the digest reports travel by the task channel, not the
    process group), for the stats; with data shards, every shard's
    ledger (a shard's times their number) against every rank's wire."""
    ranks = ms["ranks"]
    first = [rk["queries"][0]["wire"] for rk in ranks]
    n = len(ranks[0]["queries"])
    wire = sum(w["nbytes"] for w in first)
    online = sum(sum(b for t, (_, b) in w["by_tag"].items()
                     if t is None or not t.startswith("pre:"))
                 for w in first)
    ledger = (led.nbytes + led.pre_nbytes
              - led.by_tag.get("verify.digest", (0, 0))[1]) * ms["data"]
    return {"rank_wire_bytes": [w["nbytes"] for w in first],
            "rank_wire_messages": [w["messages"] for w in first],
            "wire_bytes": wire, "wire_online_bytes": online,
            "ledger_bytes": ledger,
            "wire_rel_diff": abs(wire - ledger) / ledger if ledger else
            float(wire != 0),
            "rank_seconds": [rk["seconds"] for rk in ranks],
            "rank_staging_ms_per_query": [
                1e3 * sum(q["wire"]["staging_s"] for q in rk["queries"]) / n
                for rk in ranks],
            "rank_prf_calls_per_query": [
                sum(q["prf_calls"] for q in rk["queries"]) / n
                for rk in ranks],
            "rank_launches": ms["rank_launches"], "mesh_runs": ms["runs"],
            "data_shards": ms["data"],
            "rank_busy_share": ([p["busy_share"] if p else None
                                 for p in ms["profile"]]
                                if ms["profile"] else None),
            "wall_seconds": ms["wall_s"]}


def _check_prediction(pred, led, offline, verifier):
    """The cost model's prediction against a query's live ledger, online
    and offline (``offline``: the plant's per-query ledger under the
    pool, else the query's own ``pre:`` rows).  The verifier's
    ``verify.digest`` row, which the model does not predict, is taken
    out of the online totals and held to its own size: one round and
    3 x 4 bytes an entry."""
    vr, vb = led.by_tag.get("verify.digest", (0, 0))
    if verifier is not None:
        n = sum(len(e) for e in verifier.rows.values())
        want = (1 if verifier.meta else 0, 3 * 4 * n)
        if (vr, vb) != want:
            raise RuntimeError(f"verify.digest row {(vr, vb)} != {want}")
    if offline is not led and (offline.rounds, offline.nbytes, led.pre_rounds,
                               led.pre_nbytes) != (0, 0, 0, 0):
        raise RuntimeError("the plant recorded online rows or the "
                           "tape-backed query offline ones")
    got = (led.rounds - vr, led.nbytes - vb, offline.pre_rounds,
           offline.pre_nbytes)
    if (pred.rounds, pred.nbytes, pred.pre_rounds, pred.pre_nbytes) != got:
        raise RuntimeError(
            f"cost-model prediction {pred.total} diverged from the "
            f"ledger {got[0]} / {got[1]} online, {got[2]} / {got[3]} "
            f"offline")
    return got


def serve(net: str = "MnistNet1", batch: int = 32, queries: int = 4,
          device=None, seed: int = 0, params=None, x=None,
          profile: bool = False, weights: str = "shared",
          binary_linear: str = "auto", deployment=None, autotune_cache=None,
          tracer: telemetry.Tracer | None = None,
          registry: telemetry.MetricsRegistry | None = None,
          offline: str = "inline", pool_depth: int | None = None,
          verify: str = "off", backend: str = "local",
          group=None, mesh_ranks: int = 3) -> dict:
    """Build, compile, one warm-up query, then ``queries`` timed queries
    (and, with ``profile``, one profiled query after them).  ``x`` (float
    (B, H, W, C)) defaults to random ±0.5 pixels from ``seed``.
    ``deployment`` (a registry name or descriptor) is solved at
    ``batch``.  The cost model's prediction at ``batch`` must equal the
    warm-up query's live ledger (online, and offline: the query's
    ``pre:`` rows, or under ``offline="pool"`` what the plant recorded
    for one query), or this raises.

    ``offline="pool"`` serves from a tape pool of ``pool_depth`` (default
    8) slices a buffer, keyed from ``PRNGKey(seed + 11)``; the stats then
    hold the online-only rate beside the amortised one (``seconds``: the
    online time plus the queries' share of the plant's, see
    :func:`serve_pool`).  ``verify``
    ("opens" / "full") checks every query and raises
    :class:`~repro_torch.core.integrity.IntegrityError` on a deviation
    (``"full"`` also checks the model's shares and every tape slice).

    ``tracer`` records the compile, warm-up and per-query spans (and, via
    the comm listener, every query's protocol ops); ``registry`` collects
    the query latency histogram and the movement counters over the timed
    queries only.  Returns the stats dict: logits under ``"logits"``, the
    warm-up query's ``"ledger"``, the ``"predicted"`` report and the
    ``"model"``.

    ``backend="mesh"`` runs each party's program in its own process of
    ``group`` (a ``PartyGroup`` on ``device``; default: one started and
    stopped here), with every reshare, send and opening a real message
    (:func:`_mesh_queries`); the stats then add every rank's wire bytes,
    messages, staging time and launches beside the ledger's bytes, and
    the per-party spans go to the tracer's party lanes.  The mesh may use
    ``mesh_ranks`` ranks (``group``'s, when one is given): with 3 x d of
    them a batch that d divides runs as d data shards, each on a triple
    of ranks (:func:`mesh_data`; one shard under ``verify`` or the pool).
    The prediction is then a shard's, held to a shard's ledger, and the
    stats' bytes are every shard's (a shard's times d)."""
    if net not in INPUT_SHAPES:
        raise ValueError(f"unknown net {net!r}; available: "
                         + ", ".join(sorted(INPUT_SHAPES)))
    if batch < 1 or queries < 1:
        raise ValueError("batch and queries must be >= 1")
    if offline not in OFFLINE_MODES or verify not in integrity.VERIFY_MODES \
            or backend not in BACKENDS:
        raise ValueError(f"offline {offline!r} / verify {verify!r} / "
                         f"backend {backend!r}")
    if pool_depth is not None and (offline != "pool" or pool_depth < 1):
        raise ValueError("pool_depth applies to offline='pool' and must "
                         "be >= 1")
    device = resolve_device(device)
    shape = INPUT_SHAPES[net]
    dep = cost_model.resolve_deployment(deployment)
    if dep is not None:
        dep = dep.with_batch(batch)
    data = 1
    if backend == "mesh":
        data = mesh_data(batch, group.ranks if group is not None
                         else mesh_ranks, verify, offline)
    led = pred = model = None
    try:
        with telemetry.tracing(tracer):
            t0 = time.perf_counter()
            with telemetry.span("compile_secure", cat="compile", net=net,
                                batch=batch):
                model = build(net, device=device, params=params,
                              weights=weights, binary_linear=binary_linear,
                              deployment=dep, autotune_cache=autotune_cache)
                sync(device)
            compile_s = time.perf_counter() - t0
            if verify == "full":
                # structural RSS pair-consistency check on the shares
                integrity.verify_model_ingest(model)
            pred = cost_model.model_cost(model, (batch // data,) + shape)
            parties = Parties.setup(prf.PRNGKey(seed + 7), device=device)
            if x is None:
                rng = np.random.default_rng(seed)
                x = rng.integers(0, 2, (batch,) + shape) \
                    .astype(np.float32) - 0.5
            xs = share(torch.as_tensor(x, device=device),
                       prf.PRNGKey(seed + 3), RING32)
            launches0 = dict(kbuild.LAUNCHES)
            pool_st = mesh_st = None
            if backend == "mesh":
                spec = None
                if offline == "pool":
                    with telemetry.span("trace_material", cat="setup",
                                        net=net):
                        spec = trace_material(model, (batch,) + shape)
                own = group is None
                if own:
                    group = PartyGroup(device, ranks=3 * data)
                try:
                    mesh_st = _mesh_queries(
                        model, spec, parties, xs, queries, pool_depth or 8,
                        verify, device, group, prf.PRNGKey(seed + 11),
                        registry=registry, profile=profile, data=data)
                finally:
                    if own:
                        group.close()
                led, out = mesh_st["ledger"], mesh_st["logits"]
                dt = mesh_st["amortised_s"]
                pool_st = mesh_st if offline == "pool" else None
                offline_led = (make_tape_generator(spec, device).ledger
                               if spec is not None else led)
                run = mesh_st
            elif offline == "pool":
                with telemetry.span("trace_material", cat="setup", net=net):
                    spec = trace_material(model, (batch,) + shape)
                gen = make_tape_generator(spec, device)
                run = make_tape_runner(model, spec, verify=verify)
                pool_st = serve_pool(
                    run, gen, spec, parties.keys, xs.shares, queries,
                    pool_depth or 8, prf.PRNGKey(seed + 11), verify=verify,
                    device=device, registry=registry, spare=int(profile))
                led, out = pool_st["ledger"], pool_st["logits"]
                dt = pool_st["amortised_s"]
                offline_led = gen.ledger
            else:
                run = make_runner(model, verify=verify)
                with telemetry.span("warmup", cat="compile"), \
                        comm.track() as led:     # the warm-up's ledger
                    out = run(parties.keys, xs.shares)
                    sync(device)
                offline_led = led
                t0 = time.perf_counter()
                if telemetry.enabled():
                    with telemetry.collecting(registry):
                        for q in range(queries):
                            with telemetry.span(f"query[{q}]", cat="online",
                                                lane="parties"):
                                tq = time.perf_counter()
                                out = run(parties.keys, xs.shares)
                                sync(device)
                                telemetry.observe(
                                    "query_latency_seconds",
                                    time.perf_counter() - tq)
                else:
                    for _ in range(queries):
                        out = run(parties.keys, xs.shares)
                sync(device)
                dt = time.perf_counter() - t0
            assert tuple(out.shape) == (batch, 10), out.shape
            verifier = (mesh_st["verifier"] if mesh_st is not None
                        else run.verifier)
            got = _check_prediction(pred, led, offline_led, verifier)
            # every shard sends a shard's bytes, in the same rounds
            got = (got[0], got[1] * data, got[2], got[3] * data)
    except integrity.IntegrityError as e:
        if registry is not None and not any(
                k[0] == "integrity_aborts_total" for k in registry.counters):
            # raised where the registry was not installed (the warm-up)
            registry.inc("integrity_aborts_total", op=e.op or "?")
        e.serve_context = {"ledger": led, "predicted": pred, "model": model}
        raise
    per_query = {k: (v - launches0[k]) // (queries + 1)
                 for k, v in kbuild.LAUNCHES.items()}
    if mesh_st is not None:   # the ranks launched them
        per_query = {k: sum(rl.get(k, 0) for rl in mesh_st["rank_launches"])
                     // mesh_st["runs"] for k in kbuild.LAUNCHES}
    prof = None
    if profile and mesh_st is not None:
        prof = mesh_st["profile"]
    elif profile:
        if pool_st is not None:
            sl = pool_st["pool"].take()
            sync(device)
            prof = profile_once(lambda: run(parties.keys, xs.shares, sl),
                                device, pool_st["online_s"] / queries)
        else:
            prof = profile_once(lambda: run(parties.keys, xs.shares),
                                device, dt / queries)
    qps = queries / dt
    st = {"profile": prof, "net": net, "weights": weights,
          "binary_linear": binary_linear, "batch": batch,
          "queries": queries, "offline": offline, "verify": verify,
          "backend": backend,
          "device": str(device),
          "kind": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
          "compile_s": compile_s, "seconds": dt,
          "query_per_s": qps, "img_per_s": qps * batch,
          "online_rounds": got[0], "online_bytes": got[1],
          "offline_rounds": got[2], "offline_bytes": got[3],
          "launches_per_query": per_query,
          "deployment": dep.name if dep is not None else None,
          "predicted_rounds": pred.rounds,
          "predicted_bytes": pred.nbytes * data,
          "logits": out.float().cpu().numpy(),
          "ledger": led, "predicted": pred, "model": model}
    if verifier is not None:
        st["verified_ops"] = len(verifier.meta)
    if mesh_st is not None:
        st.update(_mesh_stats(mesh_st, led))
    if pool_st is not None:
        qps_on = queries / pool_st["online_s"]
        st.update({"pool_depth": pool_depth or 8,
                   "online_seconds": pool_st["online_s"],
                   "plant_seconds": pool_st["plant_s"],
                   "plant_ms_per_buffer": pool_st["plant_s"] * 1e3
                   / pool_st["pool"].generated,
                   "query_per_s_online": qps_on,
                   "img_per_s_online": qps_on * batch,
                   "refills": pool_st["refills"],
                   "tape_mb_per_query": spec.nbytes_per_query / 1e6,
                   "material": spec.summary()})
    return st


def serve_lm(d: int = 32, heads: int = 2, d_ff: int = 64, blocks: int = 2,
             vocab: int = 32, prompt_len: int = 4, gen: int = 8,
             buckets=(16, 32), customized: bool = True,
             static_norm: bool = False, queries: int = 4, seed: int = 0,
             device=None, oracle: bool = False, profile: bool = False,
             registry: telemetry.MetricsRegistry | None = None,
             backend: str = "local", group=None) -> dict:
    """Secure autoregressive LM serving (DESIGN.md §16) on ``device`` (the
    card unless ``"cpu"``).

    Shares the reference's LM (``share_lm_params(PRNGKey(seed + 1))``, on
    the card with every weight linear's limb cache), holds one decode
    step's live ledger to ``cost_model.lm_step_cost`` byte for byte (a
    mismatch raises), then serves a random prompt of ``prompt_len`` tokens
    (``default_rng(seed)``) under the keys ``split(PRNGKey(seed + 7), 3)``:
    the prefill, then ``gen`` greedy tokens, one warm-up generation and
    ``queries`` timed ones.  The step is built once for the smallest bucket
    of ``buckets`` that holds prompt + gen; serving asserts one build.
    ``oracle`` holds the greedy tokens to the fp32 oracle's (raises on a
    divergence); ``profile`` profiles one more decode step.  The active
    tracer (``telemetry.tracing``) gets the warm-up, ``prefill[T]`` and
    ``decode_step[bN]`` / ``decode_compile[bN]`` spans; ``registry``
    collects ``token_latency_seconds`` over the timed generations.

    Returns the stats: tok/s over the timed generations (prefill included,
    as the reference counts it), decode tok/s and prefill seconds apart,
    the step's ledger and prediction, kernel launches a step, peak device
    memory, the tokens, and of the last generation the opened logits of
    every step ((prompt + gen - 1, vocab), numpy, the prompt's first), the
    cache and the plaintext weights (``plain``, for the fp32 oracle).

    ``backend="mesh"``: the step runs with each party a process of
    ``group`` (default: one started and stopped here), the KV cache kept
    in the ranks (:func:`make_secure_lm_mesh`); the dealer shares the LM
    without kernel caches and each rank builds its own.  The stats then
    hold the cache gathered in the global pair layout ``(k, v)`` each
    ``(6, ...)``, every rank's wire bytes, messages and staging a step
    beside the step's ledger, and the ranks' launches a step."""
    if backend not in BACKENDS or (profile and backend == "mesh"):
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}, "
                         f"or profile is asked of the mesh (it profiles "
                         f"the local step)")
    device = resolve_device(device)
    need = prompt_len + gen
    fitting = sorted(b for b in buckets if b >= need)
    if not fitting or d % heads or queries < 1 or prompt_len < 1 \
            or gen < 1:
        raise ValueError(f"no bucket of {tuple(buckets)} holds prompt + gen "
                         f"= {need}, or d {d} % heads {heads}, queries, "
                         f"prompt or gen is out of range")
    bucket = fitting[0]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with telemetry.span("share_lm_params", cat="setup", blocks=blocks):
        lm, plain = share_lm_params(prf.PRNGKey(seed + 1), vocab, d, heads,
                                    d_ff, blocks, RING32, device=device,
                                    limbs=None if backend == "local"
                                    else False)
        sync(device)
    setup_s = time.perf_counter() - t0
    keys = prf.split(prf.PRNGKey(seed + 7), 3)
    prompt = np.random.default_rng(seed).integers(0, vocab, prompt_len) \
        .astype(np.int32)
    hd = d // heads

    # the comm a token: the live ledger of one step, byte-exact against
    # the closed form (serving never runs on a drifted cost table)
    with telemetry.span("ledger_estimate", cat="setup", bucket=bucket):
        led = comm.estimate_cost(
            lambda m, c, t, p, k: secure_decode_step(m, c, t, p, k,
                                                     customized, static_norm),
            lm, init_kv_cache(blocks, heads, hd, bucket, RING32, device="cpu"),
            0, 0, keys)
    pred = cost_model.lm_step_cost(bucket, d, heads, d_ff, blocks, vocab,
                                   RING32.nbytes, customized=customized,
                                   static_norm=static_norm)
    if (pred.rounds, pred.nbytes) != (led.rounds, led.nbytes):
        raise RuntimeError(
            f"cost-model prediction {pred.rounds} rounds / {pred.nbytes} B "
            f"diverged from the ledger {led.rounds} / {led.nbytes} B")

    mesh = own_group = None
    if backend == "mesh":
        own_group = group is None
        group = group or PartyGroup(device)
        with telemetry.span("mesh_setup", cat="setup", blocks=blocks):
            mesh = make_secure_lm_mesh(lm, group, customized, static_norm)
        del lm    # the ranks hold the pairs
        step = CompiledDecodeStep(step_fn=mesh, bucket=bucket)
    else:
        step = CompiledDecodeStep(lm, customized, static_norm, bucket=bucket)
    timing = {"prefill_s": 0.0, "decode_s": 0.0}
    wire = []    # (each rank's wire summary, seconds) of every timed step

    def new_cache(prev=None):
        if mesh is None:
            return init_kv_cache(blocks, heads, hd, bucket, RING32,
                                 device=device)
        if prev is not None:
            mesh.drop(prev)
        return mesh.new_cache(bucket)

    caches = [None]

    def one_generation():
        cache = caches[0] = new_cache(caches[0])
        sync(device)
        tp = time.perf_counter()
        with telemetry.span(f"prefill[{prompt_len}]", cat="online",
                            lane="parties"):
            lgs, cache = scan_prefill(step.raw, cache, prompt, keys)
            lg = lgs[-1].cpu().numpy()
        timing["prefill_s"] += time.perf_counter() - tp
        toks, rows = [], [lgs.cpu().numpy()]
        for p in range(prompt_len, prompt_len + gen):
            nxt = int(np.argmax(lg))   # public greedy selection
            toks.append(nxt)
            if p == prompt_len + gen - 1:
                break
            tq = time.perf_counter()
            lg, cache = step(cache, nxt, p, keys)
            lg = lg.cpu().numpy()
            dq = time.perf_counter() - tq
            if mesh is not None:
                wire.append(([rk["wire"] for rk in mesh.last],
                             [rk["seconds"] for rk in mesh.last]))
            timing["decode_s"] += dq
            telemetry.observe("token_latency_seconds", dq,
                              bucket=str(bucket))
            rows.append(lg[None])
        return toks, np.concatenate(rows), cache

    try:
        with telemetry.span("warmup", cat="compile", bucket=bucket):
            one_generation()
        timing.update(prefill_s=0.0, decode_s=0.0)
        wire.clear()
        launches0 = dict(kbuild.LAUNCHES if mesh is None else mesh.launches)
        t0 = time.perf_counter()
        with telemetry.collecting(registry):
            for _ in range(queries):
                toks, logits, cache = one_generation()
        sync(device)
        dt = time.perf_counter() - t0
        if mesh is not None:
            launched = mesh.launches
            cache = mesh.gather(cache)
        else:
            launched = kbuild.LAUNCHES
    finally:
        if own_group:
            group.close()
    if step.traces != 1:
        raise RuntimeError(f"the decode step was built {step.traces} times "
                           f"for one bucket length")
    steps = queries * (prompt_len + gen - 1)
    per_step = {k: (v - launches0.get(k, 0)) / steps
                for k, v in launched.items() if v > launches0.get(k, 0)}
    st = {"model": "lm", "backend": backend, "customized": customized,
          "static_norm": static_norm, "d": d, "heads": heads, "d_ff": d_ff,
          "blocks": blocks, "vocab": vocab, "bucket": bucket,
          "prompt": prompt_len, "gen": gen, "queries": queries,
          "device": str(device),
          "kind": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
          "setup_s": setup_s, "seconds": dt, "tok_per_s": queries * gen / dt,
          "prefill_s": timing["prefill_s"] / queries,
          "decode_s": timing["decode_s"] / queries,
          "decode_tok_per_s": (queries * (gen - 1) / timing["decode_s"]
                               if gen > 1 else None),
          "comm_kb_per_token": led.nbytes / 1e3,
          "rounds_per_token": led.rounds, "predicted_rounds": pred.rounds,
          "predicted_bytes": pred.nbytes, "traces": step.traces,
          "launches_per_token": per_step, "tokens": toks,
          "prompt_tokens": prompt.tolist(),
          "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else None),
          "ledger": led, "predicted": pred, "logits": logits,
          "cache": cache, "profile": None}
    st["plain"] = plain
    if mesh is not None:
        st["rank_launches"] = [dict(rl) for rl in mesh.rank_launches]
        n = len(wire)
        st.update({
            "rank_wire_bytes_per_step": [
                sum(w[0][r]["nbytes"] for w in wire) / n for r in range(3)],
            "rank_wire_messages_per_step": [
                sum(w[0][r]["messages"] for w in wire) / n
                for r in range(3)],
            "rank_staging_ms_per_step": [
                1e3 * sum(w[0][r]["staging_s"] for w in wire) / n
                for r in range(3)],
            "rank_step_seconds": [sum(w[1][r] for w in wire) / n
                                  for r in range(3)],
            "wire_bytes_per_step": sum(w["nbytes"] for w in wire[-1][0]),
            "ledger_bytes_per_step": led.nbytes + led.pre_nbytes})
    if profile:     # one more step, on a copy of the cache
        spare = SecureKVCache(cache.k.clone(), cache.v.clone())
        st["profile"] = profile_once(
            lambda: step(spare, toks[-1], prompt_len + gen - 1, keys),
            device, timing["decode_s"] / max(queries * (gen - 1), 1))
    if oracle:
        # token-identical to the fp32 oracle's greedy rollout
        otoks, cur = [], list(prompt)
        for _ in range(gen):
            olg = plaintext_lm_forward(plain, np.asarray(cur, np.int32),
                                       heads, customized, bucket,
                                       static_norm)
            otoks.append(int(olg[-1].argmax()))
            cur.append(otoks[-1])
        if toks != otoks:
            raise RuntimeError(f"secure decode diverged from the fp32 "
                               f"oracle: {toks} vs {otoks}")
        st["oracle_tokens"] = otoks
    return st


def make_obs(args, device=None, parties: int = 0):
    """``--trace`` / ``--metrics-*`` -> (Tracer | None, registry | None):
    both or neither.  The tracer times online spans with CUDA events on a
    CUDA ``device``; ``parties`` > 0 (the mesh backend, whose queries run
    in the party processes: host clock only) gives it one lane a party."""
    if not (args.trace or args.metrics_json or args.metrics_prom):
        return None, None
    return (telemetry.Tracer(parties=parties,
                             device=None if parties else device),
            telemetry.MetricsRegistry())


def emit_obs(args, tracer, reg, led, predicted=None, model=None,
             online_s=None, queries=1, unit="query"):
    """Write the ``--trace`` / ``--metrics-*`` outputs and print the
    predicted-vs-measured attribution table.  Measured rounds and bytes
    per row come from the per-query ledger and sum to its totals exactly;
    the measured time (``online_s`` over ``queries``) is split by
    predicted time share.  The registry's comm counters are the ledger ×
    ``queries``.  With ``led`` None (an abort before a query's ledger
    closed) only the trace and metrics are written."""
    if tracer is None and reg is None:
        return None
    rep = None
    if led is not None:     # None: aborted before a query's ledger closed
        if reg is not None:
            reg.record_ledger(led, model, queries=queries)
        per_q = online_s / queries if online_s and queries else None
        rep = telemetry.attribution(predicted, led, online_s=per_q,
                                    deployment=args.deployment)
        print(f"[serve_secure] attribution per {unit} "
              f"(deployment={rep.deployment}, "
              f"{'prediction exact' if rep.exact else 'prediction DIVERGED'}"
              f"):")
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


def _serve_lm(args, ap, tracer=None, reg=None):
    """``--model lm``: the reference's argument checks (exit code 2), then
    :func:`serve_lm` under the tracer; prints tok/s, the comm a token and
    the kernel launches a token."""
    if args.quick:
        cfg = dict(QUICK_LM)
        args.static_norm = True
    else:
        try:
            buckets = tuple(sorted(int(b) for b in args.buckets.split(",")))
        except ValueError:
            ap.error(f"--buckets {args.buckets!r} is not a comma-separated "
                     f"list of lengths")
        cfg = dict(d=args.lm_d, heads=args.lm_heads, d_ff=args.lm_ffn,
                   blocks=args.lm_blocks, vocab=args.lm_vocab,
                   prompt_len=args.prompt, gen=args.gen, buckets=buckets)
    if cfg["heads"] < 1 or cfg["d"] % cfg["heads"]:
        ap.error(f"--lm-d {cfg['d']} must divide by --lm-heads "
                 f"{cfg['heads']}")
    if cfg["prompt_len"] < 1 or cfg["gen"] < 1:
        ap.error("--prompt and --gen must be >= 1")
    need = cfg["prompt_len"] + cfg["gen"]
    if not any(b >= need for b in cfg["buckets"]):
        ap.error(f"no bucket in {list(cfg['buckets'])} fits prompt+gen = "
                 f"{need}; grow --buckets or shrink --prompt/--gen")
    if args.queries < 1:
        ap.error(f"--queries must be >= 1, got {args.queries}")
    customized = not args.softmax_attention
    with telemetry.tracing(tracer):
        st = serve_lm(**cfg, customized=customized,
                      static_norm=args.static_norm, queries=args.queries,
                      seed=args.seed, device=args.device, oracle=args.quick,
                      profile=args.profile, registry=reg,
                      backend=args.backend)
    led, pred = st["ledger"], st["predicted"]
    print(f"[serve_secure] lm cost model: predicted {pred.rounds} rounds / "
          f"{pred.nbytes:,} B/token vs measured {led.rounds} / "
          f"{led.nbytes:,} B -> exact")
    print(f"[serve_secure] lm backend={st['backend']} "
          f"{'customized' if customized else 'softmax'}"
          f"{'+static-norm' if st['static_norm'] else ''} d={st['d']} "
          f"heads={st['heads']} d_ff={st['d_ff']} blocks={st['blocks']} "
          f"vocab={st['vocab']} bucket={st['bucket']} device={st['device']} "
          f"({st['kind']}): {st['queries']}x{st['gen']} tokens in "
          f"{st['seconds']:.3f}s = {st['tok_per_s']:.3f} tok/s (prefill "
          f"{st['prefill_s']:.3f} s a prompt of {st['prompt']}; "
          f"{st['traces']} build/bucket)")
    print(f"[serve_secure] per-token comm: {led.nbytes / 1e3:.3f} KB online "
          f"({led.rounds} rounds) + {led.pre_nbytes / 1e3:.3f} KB offline "
          f"({led.pre_rounds} rounds); modeled LAN "
          f"{led.time(comm.LAN) * 1e3:.1f} ms / WAN "
          f"{led.time(comm.WAN) * 1e3:.0f} ms per token")
    print("[serve_secure] kernel launches per token: "
          + (", ".join(f"{k}={v:g}" for k, v in
                       st["launches_per_token"].items()) or "none"))
    if st["backend"] == "mesh":
        print(f"[serve_secure] mesh wire a decode step: "
              f"{st['wire_bytes_per_step']:,} B over the three ranks vs "
              f"ledger {st['ledger_bytes_per_step']:,} B (online + "
              f"offline); per rank "
              + ", ".join(f"P{r} {b:,.0f} B / {m:.0f} msgs / staging "
                          f"{ms:.3f} ms" for r, (b, m, ms) in enumerate(zip(
                              st["rank_wire_bytes_per_step"],
                              st["rank_wire_messages_per_step"],
                              st["rank_staging_ms_per_step"]))))
    if st["profile"] is not None:
        print_profile("serve_secure", "decode step", st["profile"])
    if args.quick:
        print(f"[serve_secure] quick check OK: {st['gen']} greedy tokens "
              f"token-identical to the fp32 oracle ({st['tokens']})")
    st["attribution"] = emit_obs(args, tracer, reg, led,
                                 online_s=st["seconds"],
                                 queries=st["queries"] * st["gen"],
                                 unit="token")
    if args.json:
        stats = {k: v for k, v in st.items()
                 if k not in ("ledger", "predicted", "logits", "cache",
                              "plain", "attribution", "profile")}
        with open(args.json, "w") as f:
            json.dump(stats, f, indent=2)
        print(f"[serve_secure] wrote {args.json}")
    return st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("bnn", "lm"), default="bnn",
                    help="serve the BNN classifier zoo or the secure "
                         "autoregressive LM decode loop (DESIGN.md §16)")
    ap.add_argument("--backend", choices=BACKENDS, default="local",
                    help="local: the stacked three-party simulation; mesh: "
                         "one party a process (three gloo ranks on the "
                         "same device), every message really sent")
    ap.add_argument("--mesh-ranks", type=int, default=3, metavar="N",
                    help="ranks the mesh backend may use: 3 x d serve a "
                         "batch that d divides as d data shards (one "
                         "under --verify or --offline pool)")
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
    ap.add_argument("--offline", choices=OFFLINE_MODES, default="inline",
                    help="preprocessing phase (DESIGN.md §12): draw "
                         "correlated randomness inside the online query, "
                         "or serve from a pool of tape slices generated "
                         "ahead of need")
    ap.add_argument("--pool-depth", type=int, default=None, metavar="K",
                    help="queries of material per tape buffer (pool mode "
                         "only; default 8)")
    ap.add_argument("--verify", choices=integrity.VERIFY_MODES,
                    default="off",
                    help="integrity level (DESIGN.md §14): cross-check "
                         "opened values across the parties' views (opens), "
                         "plus reshare/send consistency, the model's shares "
                         "and every tape slice (full); a deviation aborts "
                         "with exit code 3 naming the layer/op/round/party")
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
    lm = ap.add_argument_group("lm serving (--model lm, DESIGN.md §16)")
    lm.add_argument("--lm-d", type=int, default=32, metavar="D",
                    help="model width")
    lm.add_argument("--lm-heads", type=int, default=2)
    lm.add_argument("--lm-ffn", type=int, default=64)
    lm.add_argument("--lm-blocks", type=int, default=2)
    lm.add_argument("--lm-vocab", type=int, default=32)
    lm.add_argument("--prompt", type=int, default=4, metavar="T",
                    help="prompt length (synthetic random tokens)")
    lm.add_argument("--gen", type=int, default=8, metavar="N",
                    help="tokens to generate greedily")
    lm.add_argument("--buckets", default="16,32", metavar="L1,L2",
                    help="padded decode lengths; the smallest bucket >= "
                         "prompt+gen is built (once)")
    lm.add_argument("--softmax-attention", action="store_true",
                    help="serve the un-customized comparison mode (full "
                         "secure softmax) instead of ReLU-attention")
    lm.add_argument("--static-norm", action="store_true",
                    help="CBNN norm customization: RMSNorm folded into the "
                         "adjacent linear at setup (zero online rounds)")
    lm.add_argument("--quick", action="store_true",
                    help="small static-norm preset + token-parity check "
                         "against the fp32 oracle")
    args = ap.parse_args(argv)
    parties = 3 if args.backend == "mesh" else 0
    if args.backend == "mesh" and args.profile and args.model == "lm":
        ap.error("--profile of --model lm profiles the local step")
    if args.model == "lm":
        if args.quick and args.queries == 4:
            args.queries = 1
        tracer, reg = make_obs(args, resolve_device(args.device), parties)
        return _serve_lm(args, ap, tracer, reg)
    for flag, dflt in (("quick", False), ("softmax_attention", False),
                       ("static_norm", False)):
        if getattr(args, flag) != dflt:
            ap.error(f"--{flag.replace('_', '-')} requires --model lm")
    # the reference's argument errors (exit code 2) before any work
    if args.net not in INPUT_SHAPES:
        ap.error(f"unknown --net {args.net!r}; available: "
                 + ", ".join(sorted(INPUT_SHAPES)))
    if args.deployment is not None \
            and args.deployment.lower() not in cost_model.DEPLOYMENTS:
        ap.error(f"unknown --deployment {args.deployment!r}; available: "
                 + ", ".join(sorted(cost_model.DEPLOYMENTS)))
    if args.batch < 1:
        ap.error(f"--batch must be >= 1, got {args.batch}")
    if args.queries < 1:
        ap.error(f"--queries must be >= 1, got {args.queries}")
    if args.weights == "public" and args.binary_linear == "generic":
        ap.error("--weights public has no generic Alg-2 route (public "
                 "layers are local share algebra); use --binary-linear "
                 "auto or off")
    if args.pool_depth is not None and args.offline != "pool":
        ap.error("--pool-depth only applies to --offline pool")
    if args.pool_depth is not None and args.pool_depth < 1:
        ap.error(f"--pool-depth must be >= 1, got {args.pool_depth}")
    tracer, reg = make_obs(args, resolve_device(args.device), parties)
    try:
        st = serve(args.net, args.batch, args.queries, args.device,
                   args.seed, profile=args.profile, weights=args.weights,
                   binary_linear=args.binary_linear,
                   deployment=args.deployment, tracer=tracer, registry=reg,
                   offline=args.offline, pool_depth=args.pool_depth,
                   verify=args.verify, backend=args.backend,
                   mesh_ranks=args.mesh_ranks)
    except integrity.IntegrityError as e:
        # a deviation aborts with diagnostics, never a wrong answer; the
        # trace and metrics are still flushed so the abort can be read
        print(f"[serve_secure] ABORT: {e}", file=sys.stderr)
        ctx = getattr(e, "serve_context", {})
        emit_obs(args, tracer, reg, ctx.get("ledger"),
                 predicted=ctx.get("predicted"), model=ctx.get("model"))
        raise SystemExit(3)
    model, pred, led = st["model"], st["predicted"], st["ledger"]
    if args.verify == "full":
        print(f"[serve_secure] model ingest verified ({len(model.ops)} "
              f"layers)")
    if args.offline == "pool":
        print(f"[serve_secure] material spec: {st['material']}")
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
          f"{st['predicted_bytes']:,} B vs measured {st['online_rounds']} / "
          f"{st['online_bytes']:,} B -> exact")
    print(f"[serve_secure] {st['net']} weights={st['weights']} "
          f"binary_linear={st['binary_linear']} offline={st['offline']} "
          f"verify={st['verify']} backend={st['backend']} "
          f"device={st['device']} "
          f"({st['kind']}) batch={st['batch']}: {st['queries']} queries in "
          f"{st['seconds']:.4f}s = {st['query_per_s']:.3f} q/s "
          f"({st['img_per_s']:.1f} img/s)")
    if args.offline == "pool":
        print(f"[serve_secure] pool depth {st['pool_depth']}: online-only "
              f"{st['query_per_s_online']:.3f} q/s "
              f"({st['img_per_s_online']:.1f} img/s), amortised "
              f"{st['query_per_s']:.3f} q/s (plant "
              f"{st['plant_ms_per_buffer']:.1f} ms a buffer), "
              f"{st['refills']} refills, {st['tape_mb_per_query']:.3f} MB "
              f"of tape a query")
    print(f"[serve_secure] per-query comm: {st['online_bytes']:,} B online "
          f"({st['online_rounds']} rounds) + {st['offline_bytes']:,} B "
          f"offline ({st['offline_rounds']} rounds)")
    print("[serve_secure] kernel launches per query: "
          + (", ".join(f"{k}={v:g}" for k, v in
                       st["launches_per_query"].items() if v) or "none"))
    if args.backend == "mesh":
        print(f"[serve_secure] mesh wire a query: {st['wire_bytes']:,} B "
              f"over {len(st['rank_wire_bytes'])} ranks, "
              f"{st['data_shards']} data shard(s) "
              f"({st['wire_online_bytes']:,} B online) "
              f"vs ledger {st['ledger_bytes']:,} B online + offline "
              f"(rel diff {st['wire_rel_diff']:.2e}); per rank "
              + ", ".join(f"rank {r} {b:,} B / {m} msgs / staging "
                          f"{ms:.3f} ms"
                          for r, (b, m, ms) in enumerate(zip(
                              st["rank_wire_bytes"],
                              st["rank_wire_messages"],
                              st["rank_staging_ms_per_query"]))))
    if isinstance(st["profile"], list):     # the mesh: one a rank
        for r, pr in enumerate(st["profile"]):
            if pr is not None:
                print_profile("serve_secure", f"P{r} query", pr)
    elif st["profile"] is not None:
        print_profile("serve_secure", "query", st["profile"])
    st["attribution"] = emit_obs(args, tracer, reg, led, predicted=pred,
                                 model=model,
                                 online_s=st.get("online_seconds",
                                                 st["seconds"]),
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
