"""Run one cell of the benchmark of the PyTorch/CUDA port of CBNN and print
its result as one JSON line.

  python3 cbnn_bench/run.py --workload cifarnet2-inline-b256 --seed 7 \\
      --seconds 45 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``cbnn_bench/configs``) and a traffic mix (``cbnn_bench/traffic``).  The
run makes its weights and images from ``--seed`` on the card, compiles the
secure model and warms it up (``setup_s``), serves a closed loop for
``--seconds``, then checks every query's opened logits against the plain
reference (``cbnn_bench/reference``).  With ``--trace 0`` the result holds
the cell's end-to-end metrics; with ``--trace 1`` a slice of the window is
profiled and the result holds its per-layer metrics, the device's busy and
window seconds and the breakdown.  The numbers compared and their limits
come last, on standard error and under ``checks`` in the result.

Exits 2 without a CUDA device (no result is printed), and 3 if a module
of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(workload: str, seed: int, seconds: float, trace: bool,
            device, t_start: float, root: Path = ROOT, overrides=None,
            wrap_runner=None, max_queries=None) -> dict:
    """One run of ``workload``: the result dict (without the JAX check).
    ``overrides`` (tests) replace traffic parameters; ``wrap_runner`` and
    ``max_queries`` as in ``harness.serve.run_window``."""
    import torch

    from cbnn_bench import counts
    from cbnn_bench.harness import check, manifest, serve
    from cbnn_bench.reference import forward as ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    bench = manifest.load(root)
    _, cfg, traffic = manifest.cell(bench, workload, root)
    traffic = {**traffic, **(overrides or {})}
    rec = serve.run_window(cfg, traffic, seed, seconds, device, trace,
                           t_start, wrap_runner=wrap_runner,
                           max_queries=max_queries)
    refs = check.reference_logits(cfg, rec["params"], rec["images"])
    checks, failed = check.compare(cfg, rec["answers"], refs)
    limbs = None
    if traffic["weights"] == "public":
        frac = cfg["ring"]["frac"]
        limbs = [tuple(ref.min_public_limbs(w, frac) for w in op["w"])
                 for op in ref.fold(rec["params"], cfg["layers"], frac,
                                    cfg["bn_eps"])
                 if op["kind"] in ("conv", "sepconv", "fc")]
    launches = counts.launches(cfg["layers"], cfg["input_shape"],
                               traffic["batch"], limbs)
    rec["count"] = {
        "ops": counts.query_ops(launches),
        **{f"{fam}_bound_s": sum(counts.bound_s(x) for x in launches
                                 if x["family"] == fam)
           for fam in ("dense", "depthwise")}}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(bench, workload, kind):
        v = manifest.load_metric(m["name"], root).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    out = {"correct": failed == 0, "attempted": rec["queries"],
           "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1,
                      "memory_peak_bytes": rec["memory_peak_bytes"]}}
    t = rec["trace"]
    if t is not None:
        out["device"].update(busy_s=t["busy_s"], window_s=t["slice_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
        out["trace_host_s"] = (t["profiler_start_s"], t["profiler_stop_s"])
    out["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                         else 1e300, "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from cbnn_bench.harness import manifest
    w, _, _ = manifest.cell(manifest.load(), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < w["chips"]:
        print(f"cbnn_bench: the cell needs {w['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"cbnn_bench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    t = res.pop("trace_host_s", None)
    if t is not None:
        print(f"trace: profiler start {t[0]:.3f} s, stop {t[1]:.3f} s "
              f"(between queries, outside every latency)", file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
