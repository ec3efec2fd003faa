"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build   - nvcc builds every kernel of the port from src/repro_torch/csrc
             (one nvcc per source, started together); prints the build
             seconds, the ptxas report and the card's name and power limit.
2. kernels - each kernel's wrapper runs on the card at every shape the main
             paths give it (collected from shape-only runs of the shared-
             and public-weight paths) and must equal its plain PyTorch
             version, computed on CPU copies of the same inputs (torch has
             no integer matmul on CUDA), exactly.  Times: CUDA events,
             median of 30 launches after warm-up.
3. path    - the port's serving entry point on the card at batch 32:
             CifarNet2 and MnistNet1 with shared weights (rss_matmul,
             grouped_rss_matmul) and with public weights (bin_rss_matmul,
             bin_grouped_matmul), build -> compile -> warm-up -> 4 queries;
             then one MnistNet1 query each under public/"off" and
             shared/"generic".  The launch counts are zeroed just before
             each run and read just after: each kernel of the run's path
             must have launched, and the other weight mode's kernels not at
             all.  The per-query ledger must equal the pinned rounds/bytes.
4. values  - with grid-quantised weights the secure logits of MnistNet1 and
             MnistNet3-sep (shared and public weights) must be within 0.05
             of the plaintext forward on the card, and CifarNet2 logits
             (shared and public) on the card must equal the CPU run of the
             port bit for bit.

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

# per-query ledger at batch 32 (online rounds, bytes, offline rounds, bytes)
# of each (net, weights, binary_linear), hardware-independent: the
# reference's secure_infer_cost gives the same
PINNED = {
    ("CifarNet2", "shared", "auto"): (33, 158_670_336, 48, 103_514_112),
    ("MnistNet1", "shared", "auto"): (6, 351_744, 8, 294_912),
    ("CifarNet2", "public", "auto"): (23, 102_043_392, 48, 103_514_112),
    ("MnistNet1", "public", "auto"): (4, 249_600, 8, 294_912),
    ("MnistNet1", "public", "off"): (6, 302_592, 8, 294_912),
    ("MnistNet1", "shared", "generic"): (6, 351_744, 8, 294_912),
}
# the kernels each weight mode's path runs (the other mode's must not run)
PATH_KERNELS = {"shared": ("rss_matmul", "grouped_rss_matmul"),
                "public": ("bin_rss_matmul", "bin_grouped_matmul")}
BATCH = 32
QUERIES = 4
HBM_BPS = 3.35e12          # H100 SXM memory rate
INT8_OPS = 1.979e15        # H100 SXM dense int8 tensor-core rate
REPLACES = {
    "rss_matmul": "src/repro/kernels/rss_matmul.py:118",
    "grouped_rss_matmul": "src/repro/kernels/bin_rss_matmul.py:331",
    "bin_rss_matmul": "src/repro/kernels/bin_rss_matmul.py:127",
    "bin_grouped_matmul": "src/repro/kernels/bin_rss_matmul.py:440",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}


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


def dots(n_limbs: int) -> int:
    """int8 limb products a cell of a public-weight product needs on the
    TPU's route: Σ_{q<L}(4 − q) (4 / 7 / 9 / 10 for L = 1..4)."""
    return sum(4 - q for q in range(n_limbs))


def path_shapes(net: str, weights: str):
    """Shapes (the grouped kernels' x layout, the public limb count) each
    wrapper receives on a main path, from a shape-only (meta) run of it."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core.secure_model import secure_infer_cost
    from repro_torch.launch.serve_secure import build
    from repro_torch.nn.bnn import INPUT_SHAPES

    seen = {name: {} for name in REPLACES}
    wrappers = {"rss_matmul": "rss_matmul_parts",
                "grouped_rss_matmul": "grouped_rss_matmul_parts",
                "bin_rss_matmul": "bin_rss_matmul_parts",
                "bin_grouped_matmul": "bin_grouped_matmul_parts"}
    saved = {name: getattr(kops, fn) for name, fn in wrappers.items()}

    def recorder(name):
        def rec(x, w):
            key = (tuple(x.shape), w.n)
            if "grouped" in name:
                key += (x.stride()[1] == 1,)
            if name.startswith("bin_"):
                key += (w.n_limbs,)
            seen[name][key] = seen[name].get(key, 0) + 1
            return saved[name](x, w)
        return rec

    for name, fn in wrappers.items():
        setattr(kops, fn, recorder(name))
    try:
        model = build(net, device="cpu", weights=weights)
        secure_infer_cost(model, (BATCH,) + INPUT_SHAPES[net])
    finally:
        for name, fn in wrappers.items():
            setattr(kops, fn, saved[name])
    return seen


def _grouped_x(words, s, c, m, k, c_contig):
    """A host (S, C, M, K) view and its card copy in the path's layout."""
    if c_contig:   # the path's im2col buffer: (S, M, K, C)
        x = words(s, m, k, c).permute(0, 3, 1, 2)
        return x, x.cuda().permute(0, 2, 3, 1).contiguous().permute(
            0, 3, 1, 2)
    x = words(s, c, m, k)
    return x, x.cuda()


def check_kernels(shapes: dict) -> list:
    """Phase 2: every kernel at every main-path shape == plain version."""
    import torch
    from repro_torch.kernels import bin_rss_matmul as grp
    from repro_torch.kernels import rss_matmul as dense

    g = torch.Generator().manual_seed(0)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=g)

    def public(n_limbs, *shape):
        """A public encoding whose minimal limb count is at most L."""
        if n_limbs == 4:
            return words(*shape)
        half = 1 << (8 * n_limbs - 2)
        return torch.randint(-half, half, shape, dtype=torch.int32,
                             generator=g)

    rows = []
    for name in REPLACES:
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
            elif name == "grouped_rss_matmul":
                (s, c, m, k), n, c_contig = key
                x, xd = _grouped_x(words, s, c, m, k, c_contig)
                wl = grp.grouped_weight_limbs(words(s, c, k, n))
                wd = grp.GroupedWeightLimbs(*(a.cuda() for a in wl))
                run = lambda: grp.grouped_rss_matmul_parts(xd, wd)
                plain = lambda: grp.grouped_rss_matmul_ref(x, wl)
                nbytes = 4 * (s * c * m * k + 2 * s * c * k * n
                              + s * c * m * n)
                ops = 40 * s * c * m * k * n
                desc = {"S": s, "C": c, "M": m, "K": k, "N": n}
            elif name == "bin_rss_matmul":
                (s, m, k), n, n_limbs = key
                x = words(s, m, k)
                wl = grp.public_weight_limbs(public(n_limbs, k, n), n_limbs)
                xd = x.cuda()
                wd = grp.PublicWeightLimbs(wl.w.cuda(), wl.wl.cuda(),
                                           n_limbs)
                run = lambda: grp.bin_rss_matmul_parts(xd, wd)
                plain = lambda: grp.bin_rss_matmul_ref(x, wl)
                nbytes = 4 * (s * m * k + k * n + s * m * n)
                ops = 2 * dots(n_limbs) * s * m * k * n
                desc = {"S": s, "M": m, "K": k, "N": n, "L": n_limbs}
            else:
                (s, c, m, k), n, c_contig, n_limbs = key
                x, xd = _grouped_x(words, s, c, m, k, c_contig)
                wl = grp.public_grouped_limbs(public(n_limbs, c, k, n),
                                              n_limbs)
                wd = grp.PublicGroupedLimbs(wl.w.cuda(), wl.wl.cuda(),
                                            n_limbs)
                run = lambda: grp.bin_grouped_matmul_parts(xd, wd)
                plain = lambda: grp.bin_grouped_matmul_ref(x, wl)
                nbytes = 4 * (s * c * m * k + c * k * n + s * c * m * n)
                ops = 2 * dots(n_limbs) * s * c * m * k * n
                desc = {"S": s, "C": c, "M": m, "K": k, "N": n,
                        "L": n_limbs}
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
        if not detail:
            fail(f"{name}: no main-path shape was collected")
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

    # -- 2. kernels vs plain versions at the main paths' shapes ------------
    # per-query counts: one query of each net under each weight mode
    shapes = {name: {} for name in REPLACES}
    for net, weights, binary_linear in PINNED:
        if binary_linear != "auto":
            continue   # the same shapes as the "auto" path of that mode
        for name, d in path_shapes(net, weights).items():
            for key, cnt in d.items():
                shapes[name][key] = shapes[name].get(key, 0) + cnt
    rows = check_kernels(shapes)

    # -- 3. main paths --------------------------------------------------------
    from repro_torch.launch.serve_secure import serve
    launches = {name: 0 for name in kbuild.LAUNCHES}
    for (net, weights, binary_linear), pinned in PINNED.items():
        queries = QUERIES if binary_linear == "auto" else 1
        kbuild.reset_launches()
        st = serve(net, BATCH, queries, device="cuda", weights=weights,
                   binary_linear=binary_linear)
        counts = dict(kbuild.LAUNCHES)
        got = (st["online_rounds"], st["online_bytes"], st["offline_rounds"],
               st["offline_bytes"])
        print(f"[chip_smoke] {net} {weights}/{binary_linear} batch {BATCH} "
              f"on {st['kind']}: {queries} queries in {st['seconds']:.4f} s "
              f"= {st['query_per_s']:.3f} q/s ({st['img_per_s']:.1f} img/s),"
              f" compile {st['compile_s']:.3f} s; ledger {got}; "
              f"launches {counts}")
        if got != pinned:
            fail(f"{net} {weights}/{binary_linear}: ledger {got} != pinned "
                 f"{pinned}")
        dense_k, grouped_k = PATH_KERNELS[weights]
        need = [dense_k] + ([grouped_k] if net == "CifarNet2" else [])
        for name in need:
            if counts[name] <= 0:
                fail(f"{net} {weights}/{binary_linear}: kernel {name} was "
                     f"not launched on the path")
        other = "public" if weights == "shared" else "shared"
        for name in PATH_KERNELS[other]:
            if counts[name] != 0:
                fail(f"{net} {weights}/{binary_linear}: kernel {name} of "
                     f"the {other}-weight path launched {counts[name]} "
                     f"times")
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
        plain, _ = bnn_forward(params, torch.as_tensor(x, device="cuda"), net)
        for weights in PATH_KERNELS:
            st = serve(net, BATCH, 1, device="cuda", params=params, x=x,
                       weights=weights)
            err = float(np.abs(st["logits"] - plain.cpu().numpy()).max())
            print(f"[chip_smoke] {net} {weights}: secure vs plaintext "
                  f"max |err| {err:.6f}")
            if not err < 0.05:
                fail(f"{net} {weights}: secure logits differ from the "
                     f"plaintext forward by {err}")
    x = np.random.default_rng(2).integers(0, 2, (2, 32, 32, 3)) \
        .astype(np.float32) - 0.5
    for weights in PATH_KERNELS:
        on_card = serve("CifarNet2", 2, 1, device="cuda", x=x,
                        weights=weights)["logits"]
        on_host = serve("CifarNet2", 2, 1, device="cpu", x=x,
                        weights=weights)["logits"]
        if not np.array_equal(on_card, on_host):
            fail(f"CifarNet2 {weights}: logits on the card differ from the "
                 f"CPU run")
        print(f"[chip_smoke] CifarNet2 {weights} batch 2: card == CPU, bit "
              f"for bit")
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
