"""A race check of B9 (``csrc/ssd_scan.cu``) by timing jitter, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd_jitter [--mutant]

B9's sums run in a fixed order, so its output may not move by one bit with
the order in which its warps and threads reach shared memory.  This builds a
copy of the source in which every thread sleeps a pseudo-random 0-4 µs (one
time in four) at each barrier, cp.async wait, slab transform, cumsum step
and store, seeded per launch, and runs each shape unjittered once and
jittered ``--seeds`` times: a jittered output that differs from the
unjittered one in any bit is a race.  It also launches the first shape on
an allocator refilled with NaN, 1e30, random and 1.0 words, which shows a
read of scratch that no pass wrote.  ``--mutant`` drops one barrier of the
C·Bᵀ pass, which the check must then report (it proves the jitter reaches
the threads).  Prints one JSON line a shape; exits 1 where a bit moved
(0 with ``--mutant`` only if every shape moved).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time

import torch

from repro_torch.kernels import build, ssd

JITTER = r'''
__device__ unsigned g_seed;
__device__ int g_jitter;
__device__ __forceinline__ void jitter(int site) {
  if (!g_jitter) return;
  unsigned h = threadIdx.x * 2654435761u ^ (blockIdx.x * 40503u
      + blockIdx.y * 977u + blockIdx.z * 131u) ^ (site * 0x9e3779b9u) ^ g_seed;
  h ^= h >> 13; h *= 0x5bd1e995u; h ^= h >> 15;
  if ((h & 3) == 0) __nanosleep((h >> 8) & 4095);
}
'''
SET_JITTER = r'''
extern "C" int ssd_set_jitter(int on, unsigned seed) {
  cudaError_t e = cudaMemcpyToSymbol(g_jitter, &on, sizeof(int));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(g_seed, &seed, sizeof(unsigned));
}
'''
# (anchor in ssd_scan.cu, the same text with a jitter point added)
SITES = [
    ("namespace {\n", "namespace {\n" + JITTER),
    ("    cp_wait<STAGES - 2>();   // slab t has landed\n",
     "    cp_wait<STAGES - 2>();   // slab t has landed\n    jitter(1);\n"),
    ("    prepare(t, st);\n    __syncthreads();",
     "    prepare(t, st);\n    jitter(2);\n    __syncthreads();\n"
     "    jitter(3);"),
    ("    if (compute(t)) slab_fma(",
     "    jitter(4);\n    if (compute(t)) slab_fma("),
    ("  if (lane == 31) wsum[warp] = v;",
     "  jitter(5);\n  if (lane == 31) wsum[warp] = v;\n  jitter(6);"),
    ("  run += off;\n", "  run += off;\n  jitter(7);\n"),
    ("  if (group() == 1)\n    store_tile<true>(part",
     "  jitter(8);\n  if (group() == 1)\n    store_tile<true>(part"),
    ("    if (nt == 0 && dtile == 0 && threadIdx.x == 0)",
     "    jitter(9);\n    if (nt == 0 && dtile == 0 && threadIdx.x == 0)"),
    ("    for (int j = threadIdx.x; j < Q; j += T) dts[",
     "    jitter(11);\n    for (int j = threadIdx.x; j < Q; j += T) dts["),
    ("  store_tile<VEC>(y + ", "  jitter(12);\n  store_tile<VEC>(y + "),
    ("                                         F f) {\n",
     "                                         F f) {\n  jitter(13);\n"),
    ("                                          int r0 = 0) {\n",
     "                                          int r0 = 0) {\n"
     "  jitter(14);\n"),
    ("  __syncthreads();\n  for (int r = ty; r < 32; r += 8) {\n"
     "    const int n = n0 + r",
     "  jitter(15);\n  __syncthreads();\n"
     "  for (int r = ty; r < 32; r += 8) {\n    const int n = n0 + r"),
    ("  float acc[8][8] = {};\n  if (ns > 0) {",
     "  jitter(16);\n  float acc[8][8] = {};\n  if (ns > 0) {"),
]
MUTANT = ("  __syncthreads();\n  if (group() == 1) return;",
          "  if (group() == 1) return;")
# B, S, H, hd, N, chunk: chip_smoke.py's three test shapes, a 256-chunk
# shape with full tiles, and an odd head count with unaligned hd and N
SHAPES = [(2, 128, 2, 32, 16, 64), (2, 256, 1, 64, 32, 64),
          (2, 64, 4, 16, 8, 32), (2, 512, 8, 64, 128, 256),
          (1, 256, 3, 40, 20, 64)]


def jittered_source(mutant: bool) -> str:
    src = (build.SOURCE_DIR / "ssd_scan.cu").read_text()
    for anchor, text in SITES + ([MUTANT] if mutant else []):
        if src.count(anchor) != 1:
            raise RuntimeError(f"ssd_jitter: anchor {anchor!r} appears "
                               f"{src.count(anchor)} times in ssd_scan.cu")
        src = src.replace(anchor, text)
    return src + SET_JITTER


def load(mutant: bool):
    """Build the jittered copy; install it as B9's entry point."""
    name = "ssd_jitter_mutant" if mutant else "ssd_jitter"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = build.BUILD_DIR / f"{name}.cu", build.BUILD_DIR / f"lib{name}.so"
    cu.write_text(jittered_source(mutant))
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([build._nvcc(), *flags, "-o", str(so), str(cu)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.ssd_scan_launch
    fn.argtypes = build.KERNELS["ssd_scan"][2]
    fn.restype = ctypes.c_int
    build._LIBS["ssd_scan"] = fn
    setj = lib.ssd_set_jitter
    setj.argtypes = [ctypes.c_int, ctypes.c_uint]
    return lambda on, seed=0: build.check("ssd_set_jitter", setj(on, seed))


def inputs(g, b, s, h, hd, n):
    return (torch.randn((b, s, h, hd), generator=g) * 0.5,
            torch.randn((b, s, n), generator=g) * 0.5,
            torch.randn((b, s, n), generator=g) * 0.5,
            -torch.rand((b, s, h), generator=g) * 0.5,
            torch.rand((b, s, h), generator=g) * 0.9 + 0.1)


def refilled(fill):
    """Allocate and free ~0.5 GB of blocks holding ``fill`` (None: normal
    random words), so the allocator's next blocks hold them."""
    junk = []
    for size in (1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22, 1 << 24):
        for _ in range(4):
            t = torch.empty(size, device="cuda")
            t.normal_() if fill is None else t.fill_(fill)
            junk.append(t)
    torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mutant", action="store_true")
    ap.add_argument("--seeds", type=int, default=300)
    args = ap.parse_args(argv)
    setj = load(args.mutant)
    g = torch.Generator().manual_seed(8)
    moved_shapes = 0
    for k, (b, s, h, hd, n, chunk) in enumerate(SHAPES):
        host = inputs(g, b, s, h, hd, n)
        dev = tuple(t.cuda() for t in host)
        want = ssd.ssd_scan_ref(*host, chunk=chunk)
        setj(0)
        y0 = ssd.ssd_scan(*dev, chunk=chunk)
        row = {"shape": [b, s, h, hd, n, chunk],
               "max_abs_err_vs_plain": float((y0.cpu() - want).abs().max()),
               "max_abs_y": float(want.abs().max())}
        if k == 0:
            row["refilled_allocator_equal"] = {}
            for label, fill in (("nan", float("nan")), ("1e30", 1e30),
                                ("random", None), ("1.0", 1.0)):
                refilled(fill)
                row["refilled_allocator_equal"][label] = torch.equal(
                    ssd.ssd_scan(*dev, chunk=chunk), y0)
        moved = []
        for seed in range(1, args.seeds + 1):
            setj(1, seed)
            y = ssd.ssd_scan(*dev, chunk=chunk)
            if not torch.equal(y, y0):
                moved.append(seed)
        for on in (0, 1):   # the jitter's cost shows that it ran
            setj(on, 7)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                ssd.ssd_scan(*dev, chunk=chunk)
            torch.cuda.synchronize()
            row["ms_a_call_jitter_" + ("on" if on else "off")] = \
                (time.perf_counter() - t0) / 50 * 1e3
        setj(0)
        row["jittered_runs"] = args.seeds
        row["jittered_runs_that_moved"] = len(moved)
        moved_shapes += bool(moved) or not all(
            row.get("refilled_allocator_equal", {True: True}).values())
        print(json.dumps(row), flush=True)
    if args.mutant:
        return 0 if moved_shapes == len(SHAPES) else 1
    return 1 if moved_shapes else 0


if __name__ == "__main__":
    sys.exit(main())
