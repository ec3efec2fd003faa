"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   - nvcc builds every kernel of the port from src/repro_torch/csrc
             (one nvcc per source, started together); prints the build
             seconds, the ptxas report and the card's name and power limit.
2. kernels - each kernel's wrapper runs on the card at every shape the main
             path gives it (collected from a shape-only run of the path) and
             must equal its plain PyTorch version, computed on CPU copies of
             the same inputs (torch has no integer matmul on CUDA), exactly.
             Times: CUDA events, median of 30 launches after warm-up.
3. path    - the port's serving entry point on the card, CifarNet2 and
             MnistNet1 at batch 32: build -> compile -> warm-up -> 4 queries.
             The launch counts are zeroed just before each net and read just
             after; each kernel of the path must have launched.  The
             per-query ledger must equal the pinned rounds/bytes.
4. values  - with grid-quantised weights the secure logits of MnistNet1 and
             MnistNet3-sep must be within 0.05 of the plaintext forward on
             the card, and CifarNet2 logits on the card must equal the CPU
             run of the port bit for bit.

Prints the kernels' JSON line, then the card's name and power limit, then
the result line.  Exits non-zero without a result when no CUDA device is
available or when the port's sources are not beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# per-query ledger at batch 32 (online rounds, bytes, offline rounds, bytes),
# hardware-independent: the reference's secure_infer_cost gives the same
PINNED = {
    "CifarNet2": (33, 158_670_336, 48, 103_514_112),
    "MnistNet1": (6, 351_744, 8, 294_912),
}
BATCH = 32
QUERIES = 4
HBM_BPS = 3.35e12          # H100 SXM memory rate
INT8_OPS = 1.979e15        # H100 SXM dense int8 tensor-core rate
REPLACES = {
    "rss_matmul": "src/repro/kernels/rss_matmul.py:118",
    "grouped_rss_matmul": "src/repro/kernels/bin_rss_matmul.py:331",
}
SOURCES = {
    "rss_matmul": "src/repro_torch/csrc/rss_matmul.cu",
    "grouped_rss_matmul": "src/repro_torch/csrc/grouped_rss_matmul.cu",
}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def median_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Device time of one launch: median over ``reps`` launches, each
    between its own pair of CUDA events.  A spin kernel holds the stream
    while the host enqueues them all, so the launches run back to back
    and the host's per-call overhead stays out of the reading."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def host_ms(fn, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def path_shapes(net: str):
    """Shapes (and the grouped kernel's x layout) each wrapper receives on
    the main path, from a shape-only (meta) run of the same path."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core.secure_model import secure_infer_cost
    from repro_torch.launch.serve_secure import build
    from repro_torch.nn.bnn import INPUT_SHAPES

    seen = {"rss_matmul": {}, "grouped_rss_matmul": {}}
    b1, b2 = kops.rss_matmul_parts, kops.grouped_rss_matmul_parts

    def rec1(x, w):
        key = (tuple(x.shape), w.n)
        seen["rss_matmul"][key] = seen["rss_matmul"].get(key, 0) + 1
        return b1(x, w)

    def rec2(x, w):
        key = (tuple(x.shape), w.n, x.stride()[1] == 1)
        seen["grouped_rss_matmul"][key] = \
            seen["grouped_rss_matmul"].get(key, 0) + 1
        return b2(x, w)

    kops.rss_matmul_parts, kops.grouped_rss_matmul_parts = rec1, rec2
    try:
        model = build(net, device="cpu")
        secure_infer_cost(model, (BATCH,) + INPUT_SHAPES[net])
    finally:
        kops.rss_matmul_parts, kops.grouped_rss_matmul_parts = b1, b2
    return seen


def check_kernels(shapes: dict) -> list:
    """Phase 2: every kernel at every main-path shape == plain version."""
    import torch
    from repro_torch.kernels import bin_rss_matmul as grp
    from repro_torch.kernels import rss_matmul as dense

    g = torch.Generator().manual_seed(0)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=g)

    rows = []
    for name in ("rss_matmul", "grouped_rss_matmul"):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0,
               "bytes_bound_ms": 0.0, "ops_bound_ms": 0.0}
        detail = []
        for key, per_query in sorted(shapes[name].items()):
            if name == "rss_matmul":
                (s, m, k), n = key
                x = words(s, m, k)
                wl = dense.precompute_weight_limbs(words(s, k, n))
                xd = x.cuda()
                wd = dense.WeightLimbs(*(a.cuda() for a in wl))
                run = lambda: dense.rss_matmul_parts(xd, wd)
                plain = lambda: dense.rss_matmul_parts_ref(x, wl)
                nbytes = 4 * (s * m * k + 2 * s * k * n + s * m * n)
                ops = 40 * s * m * k * n
                desc = {"S": s, "M": m, "K": k, "N": n}
            else:
                (s, c, m, k), n, c_contig = key
                if c_contig:   # the path's im2col buffer: (S, M, K, C)
                    x = words(s, m, k, c).permute(0, 3, 1, 2)
                    xd = x.cuda().permute(0, 2, 3, 1).contiguous() \
                        .permute(0, 3, 1, 2)
                else:
                    x = words(s, c, m, k)
                    xd = x.cuda()
                wl = grp.grouped_weight_limbs(words(s, c, k, n))
                wd = grp.GroupedWeightLimbs(*(a.cuda() for a in wl))
                run = lambda: grp.grouped_rss_matmul_parts(xd, wd)
                plain = lambda: grp.grouped_rss_matmul_ref(x, wl)
                nbytes = 4 * (s * c * m * k + 2 * s * c * k * n
                              + s * c * m * n)
                ops = 40 * s * c * m * k * n
                desc = {"S": s, "C": c, "M": m, "K": k, "N": n}
            got = run()
            torch.cuda.synchronize()
            want = plain()
            err = int((got.cpu().long() - want.long()).abs().max())
            if err != 0:
                fail(f"{name} {desc}: kernel != plain version "
                     f"(max abs err {err})")
            ms = median_ms(run)
            pms = host_ms(plain)
            b_ms = nbytes / HBM_BPS * 1e3
            o_ms = ops / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({**desc, "per_query": per_query, "ms": ms,
                           "plain_ms": pms, "bound_ms": bound,
                           "bound_by": "bytes" if b_ms >= o_ms else
                           "operations"})
            print(f"[chip_smoke] {name} {desc} x{per_query}/query: "
                  f"{ms:.5f} ms (bound {bound:.5f} ms, "
                  f"{100 * bound / ms:.1f}% of bound), plain on host "
                  f"{pms:.3f} ms, exact")
            tot["err"] = max(tot["err"], err)
            tot["ms"] += per_query * ms
            tot["plain_ms"] += per_query * pms
            tot["bound_ms"] += per_query * bound
            tot["bytes_bound_ms"] += per_query * b_ms
            tot["ops_bound_ms"] += per_query * o_ms
        rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": REPLACES[name], "launches": 0,
                     "max_abs_err": tot["err"], "ms": tot["ms"],
                     "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                     "bound_by": ("bytes" if tot["bytes_bound_ms"]
                                  >= tot["ops_bound_ms"] else "operations"),
                     "library_ms": None, "shapes": detail})
    return rows


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. build ---------------------------------------------------------
    from repro_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    logs = kbuild.build_all()
    print(f"[chip_smoke] built {sorted(logs)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {name}: {line.strip()}")
    smi = smi_line()
    print(f"[chip_smoke] card: {smi}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}"
          f" on {torch.cuda.get_device_name(0)}")

    # -- 2. kernels vs plain versions at the main path's shapes ------------
    shapes = {"rss_matmul": {}, "grouped_rss_matmul": {}}
    for net in PINNED:
        for name, d in path_shapes(net).items():
            for key, cnt in d.items():
                shapes[name][key] = shapes[name].get(key, 0) + cnt
    rows = check_kernels(shapes)

    # -- 3. main path -------------------------------------------------------
    from repro_torch.launch.serve_secure import serve
    launches = {name: 0 for name in kbuild.LAUNCHES}
    for net, pinned in PINNED.items():
        kbuild.reset_launches()
        st = serve(net, BATCH, QUERIES, device="cuda")
        counts = dict(kbuild.LAUNCHES)
        got = (st["online_rounds"], st["online_bytes"], st["offline_rounds"],
               st["offline_bytes"])
        print(f"[chip_smoke] {net} batch {BATCH} on {st['kind']}: "
              f"{QUERIES} queries in {st['seconds']:.4f} s = "
              f"{st['query_per_s']:.3f} q/s ({st['img_per_s']:.1f} img/s), "
              f"compile {st['compile_s']:.3f} s; ledger {got}; "
              f"launches {counts}")
        if got != pinned:
            fail(f"{net} ledger {got} != pinned {pinned}")
        need = ["rss_matmul"] + (["grouped_rss_matmul"]
                                 if net == "CifarNet2" else [])
        for name in need:
            if counts[name] <= 0:
                fail(f"{net}: kernel {name} was not launched on the path")
        lg = st["logits"]
        if lg.shape != (BATCH, 10) or not (abs(lg) < 1e6).all():
            fail(f"{net}: logits of shape {lg.shape} are not finite")
        for name in launches:
            launches[name] += counts[name]
    for row in rows:
        row["launches"] = launches[row["name"]]

    # -- 4. values ----------------------------------------------------------
    import numpy as np
    from repro_torch.nn.bnn import INPUT_SHAPES, bnn_forward, init_bnn
    from repro_torch.weights import grid_quantize
    for net in ("MnistNet1", "MnistNet3-sep"):
        params = grid_quantize(init_bnn(0, net, device="cuda"))
        rng = np.random.default_rng(1)
        x = rng.integers(0, 2, (BATCH,) + INPUT_SHAPES[net]) \
            .astype(np.float32) - 0.5
        st = serve(net, BATCH, 1, device="cuda", params=params, x=x)
        plain, _ = bnn_forward(params, torch.as_tensor(x, device="cuda"), net)
        err = float(np.abs(st["logits"] - plain.cpu().numpy()).max())
        print(f"[chip_smoke] {net}: secure vs plaintext max |err| {err:.6f}")
        if not err < 0.05:
            fail(f"{net}: secure logits differ from the plaintext forward "
                 f"by {err}")
    x = np.random.default_rng(2).integers(0, 2, (2, 32, 32, 3)) \
        .astype(np.float32) - 0.5
    on_card = serve("CifarNet2", 2, 1, device="cuda", x=x)["logits"]
    on_host = serve("CifarNet2", 2, 1, device="cpu", x=x)["logits"]
    if not np.array_equal(on_card, on_host):
        fail("CifarNet2 logits on the card differ from the CPU run")
    print("[chip_smoke] CifarNet2 batch 2: card == CPU, bit for bit")
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
