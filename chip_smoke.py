"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build    - nvcc builds every kernel of the port from src/repro_torch/csrc
              (one nvcc per source, started together); prints the build
              seconds, the ptxas report and the card's name and power limit.
2. kernels  - the launch floor (a 4-byte zero_ between two CUDA events:
              what any launch reads at least) is printed first; then
              each linear-layer kernel's wrapper (B1-B4) runs on the card at
              every shape the paths of phase 3 give it (collected from a
              shape-only run of each); B1 and B3 print the route each shape
              takes (int8 tensor cores, or CUDA cores at K <= 16) and its
              split-K factor, repeat every split-K shape bit for bit (its
              blocks add with atomics), and also run and time the route not
              taken (on the CUDA cores that is the kernels' earlier IMAD
              design, so each total has it beside it); B2 also runs and
              times its first design (one party a grid row, every share
              slot read twice) at every shape.  Then the ring kernels (B5
              ring_matmul, B6 bin_weight_matmul, B7 bin_bin_matmul) at the
              reference's kernel-test shapes and MnistNet4's layer shapes at
              batch 32 (B6 also with {0, 1} and full-range int8 weights);
              each must equal its plain PyTorch version, computed on CPU
              copies of the same inputs (torch has no integer matmul on
              CUDA), exactly, and B7 must repeat bit for bit at MnistNet4's
              shapes (fc1 splits K over blocks that add with atomics: a
              repeat that differs is a race).  B5 and B6 print each shape's
              route (int8 tensor cores after a pass that writes b's limb
              planes, K-major and 128-padded, or CUDA cores at K <= 16) and
              split-K factor, repeat split shapes bit for bit, hold the
              weight pass to its plain version, and run and time the route
              not taken (at K > 16 the IMAD kernel, their first design)
              beside it.  Times: CUDA events,
              median of 30 launches after warm-up; B7 also times
              torch._int_mm (cuBLAS) where its shape rules hold, and prints
              its factor to it.
3. path     - the port's serving entry point on the card at batch 32, for
              every path of PINNED: CifarNet2 and MnistNet1 with shared
              weights (rss_matmul, grouped_rss_matmul) and with public
              weights (bin_rss_matmul, bin_grouped_matmul), MnistNet1 under
              public/"off" and shared/"generic", the ReLU teacher MnistNet4
              under shared and public weights with fused rounds on and off,
              and CifarNet7 (shared, fused); build -> compile -> warm-up ->
              4 queries (1 off the "auto" route).  The launch counts are
              zeroed just before each run and read just after: the run must
              launch exactly the kernels its shape-only run called (so
              never the other weight mode's nor B5-B7).  The per-query
              ledger must equal the pinned rounds/bytes, and the ReLU nets'
              logits (He-normal weights) must be within 0.25 of the
              unbinarized plaintext forward on the card.
4. values   - with grid-quantised weights the secure logits of MnistNet1 and
              MnistNet3-sep (shared and public weights) must be within 0.05
              of the plaintext forward on the card, and CifarNet2 and
              CifarNet7 logits (shared and public) on the card must equal
              the CPU run of the port bit for bit.
5. tuned    - the autotuner over the launch choices of B1 and B3 (route,
              split-K count, B3's CUDA-core width; B2 and B4 have one) at
              every launch the paths of phase 3 make, as the cost model's
              kernel requests list them (phase 2 holds those lists equal
              to the launches of each path's shape-only run): each
              distinct launch tuned once into a cache in a temporary
              directory, every candidate equal to the plan's output bit
              for bit, each B1/B3 launch printed with the plan's config and
              time, the winner's and every candidate's.  MnistNet4 and
              CifarNet2, shared and public, served with the cache: every
              linear op carries its configs, logits == the untuned run's
              bit for bit.  The path solver: MnistNet1 and CifarNet2 under
              local / lan / wan print each layer's path, and the compiled
              prediction equals the live ledger, online and offline (with
              no deployment the ledger equals PINNED).  Telemetry:
              serve_secure on CifarNet2 shared, batch 32, 4 queries, with
              --trace and --metrics-json: a valid trace with each query's
              device time, the attribution summing to the ledger exactly,
              logits == the run without telemetry; q/s off and on from
              alternating runs.
6. offline + verify - the tape pool: MnistNet1 shared, CifarNet2 shared
              and public at batch 32, each served inline and through
              serve(offline="pool", pool_depth=4) for 8 queries (and one
              profiled query each): the online query's ledger equals the
              inline ledger's online rows and both equal PINNED; every
              online query of the pool run calls the threefry kernel zero
              times (the runners are wrapped to count it), every inline
              one more than zero; the served model's tape-backed logits
              equal the inline ones bit for bit at the same session keys;
              prints online-only, amortised (the online time plus the
              query's share of the plant's) and inline q/s, tape MB a
              query, the plant's ms a buffer of 4 (in the pool, and in
              turns against four one-query calls), the refills, and device
              kernels a query inline against tape-backed.  One query's
              tape generated on the card equals the CPU's (MnistNet1 at
              batch 32, CifarNet2 at batch 2).  The verified runtime:
              CifarNet2 shared under verify "off", "opens" and "full" in
              turns (off, opens, full, full, opens, off) gives the
              unverified logits every time, with q/s of each run,
              and the 12-cell fault matrix {reshare P1, open P1, send} x
              {corrupt, zero, replay, drop} on MnistNet1 at batch 32 under
              "full" raises IntegrityError in every cell with the CPU
              run's (op, index, tag, round, party).
7. per-dot  - one secure fc layer of MnistNet4's width (32 x 3136 -> 512)
              through linear_layer(..., dot=ops.rss_matmul_dot) under the
              "opt2" and "paper3" matmul modes, fused rounds on and off: it
              must launch B5 only (6 / 9 times a layer) and open to the value
              of the same layer on cached weight limbs (B1).
8. binary   - the binarized-product API at MnistNet4's layer shapes: a
              plaintext BNN layer (±1 x ±1, B7) and a public ±1-weight layer
              on the three shares of a secret (B6), each held to a float64
              product on the card.
9. lm kernels - B8 flash_attention at the reference's kernel-test shapes
              and a ragged S = 1000 in float32 (the CUDA-core route, at the
              reference's 2e-5), then in bf16 (the tensor-core route, each
              value within one bf16 rounding of the plain version's) a
              ragged S = 1000 with GQA, hd 32, MHA, and TinyLlama-1.1B's
              prefill shape (2, 2048, 32, 4, 64); B9 ssd_scan at the
              reference's three kernel-test shapes and at Mamba2-1.3B's
              layer shape (1 and 2, 2048, 64, 64, 128; chunk 256) on the
              inputs of a full-width Mamba2 layer, all within 2e-5 of max
              |y| and bit-identical on repeats, each beside the serial
              kernel (B9's first design, one block per (head, batch);
              held to the same gate and timed), and at the layer
              shapes each of its passes timed alone.  The plain versions
              run on the host CPU.  Times as in phase 2; B8's library column is
              scaled_dot_product_attention (causal, GQA) at the same shape.
10. lm paths - Mamba2-1.3B at full width and depth (48 layers): a 2 x 2048
              prefill layer by layer, each layer's scan on B9 (48 launches)
              and its output held to ssd_prefill's within 2^-6 of its scale
              (only bf16 roundings of the scan's output before w_out can
              differ), then serve (batch 4, prompt 16, gen 16).  Then
              TinyLlama-1.1B (22 layers): the prefill step at batch 2 x 2048
              through flash_impl=flash_attention_op launches B8 exactly 22
              times and its last-position logits are within 3% of their
              scale of the flash_impl=None (_sdpa) route's (bf16 attention
              outputs differ by an ulp here and there, and 22 layers carry
              it on); then the same serve.  One model is on the card at a
              time.  Prints prefill and decode tok/s and peak memory.
11. secure lm - the secure decoder LM of core/secure_transformer.py at
              TinyLlama-1.1B's widths (d 2048, 32 heads of 64, d_ff 5632,
              vocab 32000) inside the reference's secure block (MHA, ReLU
              FFN, no RoPE), 12 of TinyLlama's 22 blocks (a weight element
              holds 84 B on the card).  First the batched B5 on its own at
              the decode step's products (96 = 3 parties x 32 heads of
              (1, 128) x (128, bucket) and (1, 2 bucket) x (2 bucket, 64) at
              buckets 16 and 64: _bmm doubles K) == its plain version on CPU
              copies, bit for bit and on repeats, both routes and the split
              pass too, timed beside the 2-D entry looped over the batch;
              and B1 at its decode shapes (M = 1: 2048 x 2048, 2048 x 5632,
              5632 x 2048, 2048 x 32000) == its plain version, timed, with
              the sum a token.  Then serve_lm (customized attention, full
              RMSNorm; prompt 8, gen 8, buckets 16,64, a warm-up and 1 timed
              generation) with the counts zeroed before
              and read after: it must launch only B1 and the batched B5, at
              their exact counts, and its ledger equals lm_step_cost (or it
              raises); prints prefill seconds, decode tok/s, KB and rounds a
              token, peak memory, launches a token, threefry calls a step,
              and the logits' largest gap to plaintext_lm_forward relative
              to its scale and the top-1 agreement (reported, not gated).
              Last, at 2 blocks, a prompt of 4 and 2 tokens under customized
              + RMSNorm, softmax + RMSNorm and customized + static norm:
              every step's logits and the KV cache on the card == the
              port's CPU run bit for bit; then one more customized + RMSNorm
              step there, timed and profiled (device busy share, kernels).

12. mesh    - one party a process: three gloo ranks on the same card
              (core/party_group.py; every kernel built before they start).
              First B1's and B2's pair entries (one party, S = 1, the
              neighbour share from its own pointer) at every per-party
              shape of the paths below (CifarNet2 and MnistNet1 with
              shared weights; the secure LM's decode shapes at 2 blocks)
              == their plain versions, exactly (B1 on both routes, split
              shapes repeated), each timed beside the stacked entry on the
              same S = 1 inputs.  Then serve(backend="mesh"): CifarNet2
              with shared weights (B1 and B2 on their pair entries) and
              public ones (B3 and B4 at S = 2) at batch 32, local and mesh
              in turns (local, mesh, mesh, local; 4 queries a run, the
              second mesh run also profiled in every rank): the opened
              logits == local bit for bit, each rank launches the path's
              kernels once a linear layer a query (once a projection a
              step on the LM), exactly, by its own count; the three
              ranks' wire within 2% of the
              ledger's online + offline bytes; prints q/s of both, each
              rank's wire bytes, messages, staging ms and device busy
              share.  MnistNet1 from the tape pool (depth 4): zero
              threefry calls a query in every rank, online wire == online
              ledger exactly, logits == inline local; under verify "full"
              the logits == unverified, and the carried-pair fault cells
              (reshare P1, open P1, send; corrupt) raise with the local
              backend's (op, index, tag, round, party).  Last the secure
              LM at SLM's widths and 2 blocks (prompt 4, gen 4, bucket 16)
              on both backends: logits, tokens and every rank's pair of
              the KV cache == local bit for bit, tok/s of both, the wire a
              decode step == its ledger.

Prints the kernels' JSON line (twelve rows: the nine kernels, B5's batched
entry and B1's and B2's pair entries, each with its launches by phase),
then the card's name and power limit, then the result line.  Exits
non-zero without a result when no CUDA device is available or when the
port's sources are not beside this script.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# per-query ledger at batch 32 (online rounds, bytes, offline rounds, bytes)
# of each served path (net, weights, binary_linear, fused rounds),
# hardware-independent: the reference's secure_infer_cost gives the same
PINNED = {
    ("CifarNet2", "shared", "auto", True): (33, 158_670_336, 48, 103_514_112),
    ("MnistNet1", "shared", "auto", True): (6, 351_744, 8, 294_912),
    ("CifarNet2", "public", "auto", True): (23, 102_043_392, 48, 103_514_112),
    ("MnistNet1", "public", "auto", True): (4, 249_600, 8, 294_912),
    ("MnistNet1", "public", "off", True): (6, 302_592, 8, 294_912),
    ("MnistNet1", "shared", "generic", True): (6, 351_744, 8, 294_912),
    ("MnistNet4", "shared", "auto", True): (23, 105_762_048, 36, 76_455_936),
    ("MnistNet4", "shared", "auto", False): (54, 156_732_672, 36, 76_455_936),
    ("MnistNet4", "public", "auto", True): (23, 91_110_912, 36, 76_455_936),
    ("MnistNet4", "public", "auto", False): (50, 142_081_536, 36, 76_455_936),
    ("CifarNet7", "shared", "auto", True): (59, 626_208_000, 92, 418_185_216),
}
# the ReLU teachers: served with He-normal weights, held to the plaintext
# forward within the reference's ReLU-net bound
RELU_NETS = ("MnistNet4", "CifarNet7")
WEIGHT_MODES = ("shared", "public")
BATCH = 32
QUERIES = 4
HBM_BPS = 3.35e12          # H100 SXM memory rate
INT8_OPS = 1.979e15        # H100 SXM dense int8 tensor-core rate
BF16_OPS = 989e12          # H100 SXM dense bf16 tensor-core rate
FP32_OPS = 67e12           # H100 SXM float32 rate outside the tensor cores
LINEAR_KERNELS = ("rss_matmul", "grouped_rss_matmul", "bin_rss_matmul",
                  "bin_grouped_matmul")
# int8 limb products a cell of each ring kernel needs on the TPU's route
RING_DOTS = {"ring_matmul": 10, "bin_weight_matmul": 4, "bin_bin_matmul": 1}
# the reference's kernel-test shapes, and MnistNet4's layer shapes at batch
# 32 (conv1, conv2 as im2col products; fc1, fc2): (M, K, N)
RING_TEST_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 512, 128),
                    (64, 96, 32), (33, 17, 5), (1, 128, 1)]
MNIST4_SHAPES = [(25088, 25, 32), (6272, 800, 64), (32, 3136, 512),
                 (32, 512, 10)]
REPLACES = {
    "rss_matmul": "src/repro/kernels/rss_matmul.py:118",
    "rss_matmul_pair": "src/repro/kernels/rss_matmul.py:118",
    "grouped_rss_matmul_pair": "src/repro/kernels/bin_rss_matmul.py:331",
    "ring_matmul_batched": "src/repro/kernels/ring_matmul.py:27",
    "grouped_rss_matmul": "src/repro/kernels/bin_rss_matmul.py:331",
    "bin_rss_matmul": "src/repro/kernels/bin_rss_matmul.py:127",
    "bin_grouped_matmul": "src/repro/kernels/bin_rss_matmul.py:440",
    "ring_matmul": "src/repro/kernels/ring_matmul.py:27",
    "bin_weight_matmul": "src/repro/kernels/binary_matmul.py:22",
    "bin_bin_matmul": "src/repro/kernels/binary_matmul.py:72",
    "flash_attention": "src/repro/kernels/flash_attention.py:23",
    "ssd_scan": "src/repro/kernels/ssd.py:20",
}
SOURCES = {**{name: f"src/repro_torch/csrc/{name}.cu"
              for name in LINEAR_KERNELS + ("ring_matmul", "flash_attention",
                                            "ssd_scan")},
           "ring_matmul_batched": "src/repro_torch/csrc/ring_matmul.cu",
           "rss_matmul_pair": "src/repro_torch/csrc/rss_matmul.cu",
           "grouped_rss_matmul_pair":
               "src/repro_torch/csrc/grouped_rss_matmul.cu",
           "bin_weight_matmul": "src/repro_torch/csrc/binary_matmul.cu",
           "bin_bin_matmul": "src/repro_torch/csrc/binary_matmul.cu"}


# B8: the reference's kernel-test shapes (B, S, H, Hkv, hd) in float32 and
# a ragged S; in bf16 a ragged S with GQA, hd 32, MHA, and TinyLlama-1.1B's
# prefill at batch 2 x 2048 (last: the row's numbers)
FLASH_SHAPES = [(2, 256, 4, 4, 64, "float32"), (2, 256, 8, 2, 64, "float32"),
                (2, 128, 4, 1, 32, "float32"), (2, 1000, 4, 2, 64, "float32"),
                (2, 1000, 8, 2, 64, "bfloat16"),
                (2, 128, 4, 1, 32, "bfloat16"), (2, 256, 4, 4, 64, "bfloat16"),
                (2, 2048, 32, 4, 64, "bfloat16")]
BB_REPEATS = 5             # B7 repeats at MnistNet4's shapes, bit for bit
SPLIT_REPEATS = 5          # B1 / B3 repeats at their split-K shapes
# B9: the reference's kernel-test shapes (B, S, H, hd, N, chunk); Mamba2's
# layer shape comes from a full-width layer
SSD_SHAPES = [(2, 128, 2, 32, 16, 64), (2, 256, 1, 64, 32, 64),
              (2, 64, 4, 16, 8, 32)]
LM_BATCH, LM_SEQ = 2, 2048                  # prefill at full width
SERVE = dict(batch=4, prompt_len=16, gen=16)
LM_TOL, SSD_LAYER_TOL = 0.03, 2.0 ** -6
# B9 vs its plain version, relative to max |y|: both sides run the same
# float32 chunk math; the largest reading of a sound kernel is 7.7e-6 (at
# Mamba2's layer, whose terms cancel to a max |y| of 0.07), so 2e-5 keeps
# a 2.6x margin for the plain side's summation order on another host CPU
SSD_REL_TOL = 2e-5
SSD_REPEATS = 200          # repeats at each test shape (5 at Mamba2's)
# phase 6: the tape pool's nets, depth and queries; the fault matrix
POOL_NETS = [("MnistNet1", "shared"), ("CifarNet2", "shared"),
             ("CifarNet2", "public")]
POOL_DEPTH, POOL_QUERIES = 4, 8
FAULT_OPS = (("reshare", 1), ("open", 1), ("send", None))
FAULT_MODES = ("corrupt", "zero", "replay", "drop")
# phase 11: the secure LM at TinyLlama-1.1B's widths inside the reference's
# secure block (MHA, ReLU FFN, no RoPE: share_lm_params' architecture, not
# TinyLlama's), 12 of its 22 blocks: a weight element holds 84 B on the
# card (12 B of shares, 72 B of WeightLimbs), so 12 blocks are ~46 GB
SLM = dict(d=2048, heads=32, d_ff=5632, vocab=32000)
SLM_BLOCKS = 12
# one timed generation (two until phase 12 came: the script's time limit)
SLM_SERVE = dict(prompt_len=8, gen=8, buckets=(16, 64), queries=1)
SLM_CHECK = dict(blocks=2, prompt_len=4, gen=2)    # card == CPU
SLM_MODES = ((True, False), (False, False), (True, True))  # custom/softmax
B5_BATCH = 3 * 32          # one product per (party, head)
# B1's decode shapes (K, N) at M = 1 and their launches a token at 12
# blocks: wq wk wv wo, up, down, the head
B1_DECODE = {(2048, 2048): 4 * SLM_BLOCKS, (2048, 5632): SLM_BLOCKS,
             (5632, 2048): SLM_BLOCKS, (2048, 32000): 1}
# phase 12: the classifier paths served with one party a process (their
# per-party B1 / B2 shapes are the stacked ones at S = 1), queries a run,
# and the secure LM at SLM's widths, 2 blocks
MESH_PATHS = (("CifarNet2", "shared", "auto", True),
              ("MnistNet1", "shared", "auto", True))
MESH_QUERIES = 4
MESH_LM = dict(blocks=2, prompt_len=4, gen=4, buckets=(16,), queries=1)


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


def path_shapes(net: str, weights: str, binary_linear: str, fused: bool):
    """Shapes (the grouped kernels' x layout, the public limb count) each
    wrapper receives on a path, from a shape-only (meta) run of it; and
    the cost model's kernel requests of the path, which must list those
    launches exactly, in order (the autotuner tunes what they name)."""
    import repro_torch.kernels.ops as kops
    from repro_torch.core import cost_model, linear
    from repro_torch.core.secure_model import secure_infer_cost
    from repro_torch.launch.serve_secure import build
    from repro_torch.nn.bnn import INPUT_SHAPES

    seen = {name: {} for name in LINEAR_KERNELS}
    calls = []
    wrappers = {"rss_matmul": "rss_matmul_parts",
                "grouped_rss_matmul": "grouped_rss_matmul_parts",
                "bin_rss_matmul": "bin_rss_matmul_parts",
                "bin_grouped_matmul": "bin_grouped_matmul_parts"}
    saved = {name: getattr(kops, fn) for name, fn in wrappers.items()}

    def recorder(name):
        def rec(x, w, *args, **kw):
            key = (tuple(x.shape), w.n)
            if "grouped" in name:
                key += (x.stride()[1] == 1,)
            if name.startswith("bin_"):
                key += (w.n_limbs,)
            seen[name][key] = seen[name].get(key, 0) + 1
            grouped = "grouped" in name
            calls.append((name, *x.shape[-2:], w.n,
                          w.n_limbs if name.startswith("bin_") else 4,
                          x.shape[1] if grouped else None))
            return saved[name](x, w, *args, **kw)
        return rec

    for name, fn in wrappers.items():
        setattr(kops, fn, recorder(name))
    linear.set_fused_rounds(fused)
    try:
        model = build(net, device="cpu", weights=weights,
                      binary_linear=binary_linear)
        shape = (BATCH,) + INPUT_SHAPES[net]
        secure_infer_cost(model, shape)
        reqs = cost_model.model_cost(model, shape).kernel_requests()
    finally:
        linear.set_fused_rounds(True)
        for name, fn in wrappers.items():
            setattr(kops, fn, saved[name])
    if reqs != calls:
        fail(f"{net} {weights}/{binary_linear} fused={fused}: the cost "
             f"model's kernel requests {reqs} != the launches {calls}")
    return seen, reqs


def _grouped_x(words, s, c, m, k, c_contig):
    """A host (S, C, M, K) view and its card copy in the path's layout."""
    if c_contig:   # the path's im2col buffer: (S, M, K, C)
        x = words(s, m, k, c).permute(0, 3, 1, 2)
        return x, x.cuda().permute(0, 2, 3, 1).contiguous().permute(
            0, 3, 1, 2)
    x = words(s, c, m, k)
    return x, x.cuda()


def on_card(cache):
    """A weight cache (a NamedTuple of tensors and ints) on the card."""
    import torch
    return type(cache)(*(a.cuda() if isinstance(a, torch.Tensor) else a
                         for a in cache))


def check_kernels(shapes: dict) -> list:
    """Phase 2: every kernel at every main-path shape == plain version."""
    import torch
    from repro_torch.kernels import bin_rss_matmul as grp
    from repro_torch.kernels import limbs
    from repro_torch.kernels import rss_matmul as dense
    from repro_torch.kernels.lowering import KernelConfig

    sms = limbs.sm_count(torch.device("cuda"))

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
    for name in LINEAR_KERNELS:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0,
               "bytes_bound_ms": 0.0, "ops_bound_ms": 0.0,
               "word_bound_ms": 0.0}
        detail = []
        for key, per_query in sorted(shapes[name].items()):
            plan = other = first = None
            word_bytes = None   # B3 / B4: the weight counted as int32 words
            if name == "rss_matmul":
                (s, m, k), n = key
                x = words(s, m, k)
                wl = dense.precompute_weight_limbs(words(s, k, n))
                xd, wd = x.cuda(), on_card(wl)
                run = lambda: dense.rss_matmul_parts(xd, wd)
                plain = lambda: dense.rss_matmul_parts_ref(x, wl)
                plan = limbs.limb_mma_plan(s, m, k, n, sms)
                other = lambda r: dense._launch(xd, wd, KernelConfig(r))
                nbytes = 4 * (s * m * k + 2 * s * k * n + s * m * n)
                ops = 40 * s * m * k * n
                desc = {"S": s, "M": m, "K": k, "N": n}
            elif name == "grouped_rss_matmul":
                (s, c, m, k), n, c_contig = key
                x, xd = _grouped_x(words, s, c, m, k, c_contig)
                wl = grp.grouped_weight_limbs(words(s, c, k, n))
                wd = on_card(wl)
                run = lambda: grp.grouped_rss_matmul_parts(xd, wd)
                plain = lambda: grp.grouped_rss_matmul_ref(x, wl)
                first = lambda: grp._launch(xd, wd, grp.PER_PARTY)
                nbytes = 4 * (s * c * m * k + 2 * s * c * k * n
                              + s * c * m * n)
                ops = 40 * s * c * m * k * n
                desc = {"S": s, "C": c, "M": m, "K": k, "N": n}
            elif name == "bin_rss_matmul":
                (s, m, k), n, n_limbs = key
                x = words(s, m, k)
                wl = grp.public_weight_limbs(public(n_limbs, k, n), n_limbs)
                xd, wd = x.cuda(), on_card(wl)
                run = lambda: grp.bin_rss_matmul_parts(xd, wd)
                plain = lambda: grp.bin_rss_matmul_ref(x, wl)
                plan = limbs.limb_mma_plan(s, m, k, n, sms)
                other = lambda r: grp._launch_bin(xd, wd, KernelConfig(r))
                # x words, the weight's L int8 limbs, z words
                nbytes = 4 * s * m * k + n_limbs * k * n + 4 * s * m * n
                word_bytes = 4 * (s * m * k + k * n + s * m * n)
                ops = 2 * dots(n_limbs) * s * m * k * n
                desc = {"S": s, "M": m, "K": k, "N": n, "L": n_limbs}
            else:
                (s, c, m, k), n, c_contig, n_limbs = key
                x, xd = _grouped_x(words, s, c, m, k, c_contig)
                wl = grp.public_grouped_limbs(public(n_limbs, c, k, n),
                                              n_limbs)
                wd = on_card(wl)
                run = lambda: grp.bin_grouped_matmul_parts(xd, wd)
                plain = lambda: grp.bin_grouped_matmul_ref(x, wl)
                nbytes = 4 * s * c * m * k + c * k * n * n_limbs \
                    + 4 * s * c * m * n
                word_bytes = 4 * (s * c * m * k + c * k * n + s * c * m * n)
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
            route = ""
            if plan is not None:
                desc.update(route=plan[0], splits=plan[2])
                route = f", {plan[0]}, split-K {plan[2]}"
                if plan[2] > 1:   # the blocks add with atomics
                    for _ in range(SPLIT_REPEATS):
                        if not torch.equal(run(), got):
                            fail(f"{name} {desc}: repeats of one launch "
                                 f"differ")
                    route += f", {SPLIT_REPEATS} repeats bit-identical"
            ms = median_ms(run)
            pms = host_ms(plain)
            if plan is not None:   # time the route not taken
                alt = (limbs.CUDA_CORE if plan[0] == limbs.TENSOR_CORE
                       else limbs.TENSOR_CORE)
                if not torch.equal(other(alt), got):
                    fail(f"{name} {desc}: the {alt} route != plain version")
                desc["other_route_ms"] = median_ms(lambda: other(alt))
                route += f"; {alt} {desc['other_route_ms']:.5f} ms"
            if first is not None:   # B2's first design, one party a grid row
                if not torch.equal(first(), got):
                    fail(f"{name} {desc}: the per-party kernel != plain "
                         f"version")
                first_ms = median_ms(first)
                route += f"; per-party kernel {first_ms:.5f} ms"
            b_ms = nbytes / HBM_BPS * 1e3
            o_ms = ops / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({**desc, "per_query": per_query, "ms": ms,
                           "plain_ms": pms, "bound_ms": bound,
                           "bound_by": "bytes" if b_ms >= o_ms else
                           "operations"})
            if first is not None:
                detail[-1]["per_party_ms"] = first_ms
            print(f"[chip_smoke] {name} {desc} x{per_query}/query: "
                  f"{ms:.5f} ms (bound {bound:.5f} ms, "
                  f"{100 * bound / ms:.1f}% of bound), plain on host "
                  f"{pms:.3f} ms, exact{route}")
            tot["err"] = max(tot["err"], err)
            tot["ms"] += per_query * ms
            tot["plain_ms"] += per_query * pms
            tot["bound_ms"] += per_query * bound
            tot["bytes_bound_ms"] += per_query * b_ms
            tot["ops_bound_ms"] += per_query * o_ms
            if word_bytes is not None:
                tot["word_bound_ms"] += per_query * max(
                    word_bytes / HBM_BPS * 1e3, o_ms)
            if plan is not None:
                tot["cuda_core_ms"] = tot.get("cuda_core_ms", 0.0) \
                    + per_query * (ms if plan[0] == limbs.CUDA_CORE
                                   else desc["other_route_ms"])
            if first is not None:
                tot["per_party_ms"] = tot.get("per_party_ms", 0.0) \
                    + per_query * first_ms
        if not detail:
            fail(f"{name}: no main-path shape was collected")
        print(f"[chip_smoke] {name} over one query of each path: "
              f"{tot['ms']:.5f} ms, bound {tot['bound_ms']:.5f} ms"
              + (f" (weight as int32 words: {tot['word_bound_ms']:.5f} ms)"
                 if tot["word_bound_ms"] else "")
              + (f"; all on the CUDA cores {tot['cuda_core_ms']:.5f} ms"
                 if "cuda_core_ms" in tot else "")
              + (f"; the per-party kernel {tot['per_party_ms']:.5f} ms "
                 f"({tot['per_party_ms'] / tot['ms']:.2f}x)"
                 if "per_party_ms" in tot else ""))
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": tot["err"], "ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": ("bytes" if tot["bytes_bound_ms"]
                            >= tot["ops_bound_ms"] else "operations"),
               "library_ms": None, "shapes": detail}
        if "per_party_ms" in tot:
            row["per_party_ms"] = tot["per_party_ms"]
        rows.append(row)
    return rows


def check_ring_kernels() -> list:
    """Phase 2, B5-B7: each ring kernel at the reference's kernel-test
    shapes and MnistNet4's layer shapes == its plain version, exactly.
    A row's times and bounds sum MnistNet4's four layer shapes (one launch
    each); B7's library column sums torch._int_mm where its shape rules
    (M > 16, K and N multiples of 8) hold."""
    import torch
    from repro_torch.kernels import binary_matmul as binmm
    from repro_torch.kernels import limbs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ring_matmul as ringmm

    sms = limbs.sm_count(torch.device("cuda"))
    g = torch.Generator().manual_seed(1)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=g)

    def binary(kind, *shape):
        if kind == "int8":   # full range, the extremes included
            v = torch.randint(-128, 128, shape, dtype=torch.int8,
                              generator=g)
            v.view(-1)[:2] = torch.tensor([-128, 127], dtype=torch.int8)
            return v
        v = torch.randint(0, 2, shape, dtype=torch.int8, generator=g)
        return 2 * v - 1 if kind == "pm1" else v

    routes = {
        "ring_matmul": (kops.ring_matmul_op, ringmm.ring_matmul_ref),
        "bin_weight_matmul": (kops.binary_weight_matmul_op,
                              binmm.binary_weight_matmul_ref),
        "bin_bin_matmul": (kops.binary_binary_matmul_op,
                           binmm.binary_binary_matmul_ref),
    }
    # B5 and B6: (forced-route launch, weight pass, its plain version)
    limb_routes = {
        "ring_matmul": (ringmm._launch_ring, ringmm.split_weight_limbs,
                        ringmm.ring_weight_limbs_ref),
        "bin_weight_matmul": (binmm._launch_bin_weight,
                              binmm.binary_weight_t,
                              binmm.binary_weight_t_ref),
    }
    rows = []
    for name, (op, plain) in routes.items():
        cases = [(shape, "pm1") for shape in RING_TEST_SHAPES + MNIST4_SHAPES]
        if name == "bin_weight_matmul":
            cases += [((128, 256, 128), "pm1"), ((128, 256, 128), "01"),
                      ((6272, 800, 64), "int8"), ((32, 3136, 512), "int8")]
        detail = []
        tot = {"ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
               "library_ms": 0.0, "ms_library_shapes": 0.0, "imad_ms": 0.0}
        for (m, k, n), kind in cases:
            if name == "ring_matmul":
                a, b = words(m, k), words(k, n)
                nbytes = 4 * (m * k + k * n + m * n)
            elif name == "bin_weight_matmul":
                a, b = words(m, k), binary(kind, k, n)
                nbytes = 4 * m * k + k * n + 4 * m * n
            else:
                a, b = binary("pm1", m, k), binary(kind, k, n)
                nbytes = m * k + k * n + 4 * m * n
            ad, bd = a.cuda(), b.cuda()
            run = lambda: op(ad, bd)
            got = run()
            torch.cuda.synchronize()
            want = plain(a, b)
            if not torch.equal(got.cpu(), want):
                err = int((got.cpu().long() - want.long()).abs().max())
                fail(f"{name} ({m}, {k}, {n}) {kind}: kernel != plain "
                     f"version (max abs err {err})")
            if name == "bin_bin_matmul" and (m, k, n) in MNIST4_SHAPES:
                for _ in range(BB_REPEATS):
                    if not torch.equal(run(), got):
                        fail(f"{name} ({m}, {k}, {n}): repeats of one "
                             f"launch differ")
            extra, note = {}, ""
            if name in limb_routes:
                # the plan's route and split-K factor; split shapes repeat
                # bit for bit (int32 atomics); the weight pass == its plain
                # version; the route not taken (the IMAD kernel at K > 16)
                # checked and timed
                launch, wpass, wpass_ref = limb_routes[name]
                plan = limbs.limb_mma_plan(1, m, k, n, sms)
                extra = {"limb_route": plan[0], "splits": plan[2]}
                note = f", {plan[0]}, split-K {plan[2]}"
                if plan[2] > 1:
                    for _ in range(SPLIT_REPEATS):
                        if not torch.equal(run(), got):
                            fail(f"{name} ({m}, {k}, {n}): repeats of one "
                                 f"launch differ")
                    note += f", {SPLIT_REPEATS} repeats bit-identical"
                if not torch.equal(wpass(bd).cpu(), wpass_ref(b)):
                    fail(f"{name} ({m}, {k}, {n}): the weight pass != its "
                         f"plain version")
                alt = (limbs.CUDA_CORE if plan[0] == limbs.TENSOR_CORE
                       else limbs.TENSOR_CORE)
                alt_run = lambda: launch(ad, bd, alt)
                if not torch.equal(alt_run().cpu(), want):
                    fail(f"{name} ({m}, {k}, {n}): the {alt} route != "
                         f"plain version")
                extra["other_route_ms"] = median_ms(alt_run)
                note += f"; {alt} {extra['other_route_ms']:.5f} ms"
            ms = median_ms(run)
            pms = host_ms(lambda: plain(a, b))
            lib = None
            if name == "bin_bin_matmul" and m > 16 and k % 8 == 0 \
                    and n % 8 == 0:
                if not torch.equal(torch._int_mm(ad, bd).cpu(), want):
                    fail(f"torch._int_mm ({m}, {k}, {n}) disagrees")
                lib = median_ms(lambda: torch._int_mm(ad, bd))
            b_ms = nbytes / HBM_BPS * 1e3
            o_ms = 2 * RING_DOTS[name] * m * k * n / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({"M": m, "K": k, "N": n, "weights": kind,
                           "ms": ms, "plain_ms": pms, "bound_ms": bound,
                           "bound_by": "bytes" if b_ms >= o_ms
                           else "operations", "library_ms": lib, **extra})
            print(f"[chip_smoke] {name} ({m}, {k}, {n}) {kind}: {ms:.5f} ms "
                  f"(bound {bound:.5f} ms, {100 * bound / ms:.1f}% of "
                  f"bound), plain on host {pms:.3f} ms"
                  + (f", torch._int_mm {lib:.5f} ms ({ms / lib:.2f}x)"
                     if lib is not None else "") + ", exact" + note
                  + (f", {BB_REPEATS} repeats bit-identical"
                     if name == "bin_bin_matmul" and (m, k, n) in MNIST4_SHAPES
                     else ""))
            if (m, k, n) in MNIST4_SHAPES and kind == "pm1":
                tot["ms"] += ms
                tot["plain_ms"] += pms
                tot["bytes_ms"] += b_ms
                tot["ops_ms"] += o_ms
                if lib is not None:
                    tot["library_ms"] += lib
                    tot["ms_library_shapes"] += ms
                if name in limb_routes:   # the IMAD kernel's time
                    tot["imad_ms"] += (ms if extra["limb_route"]
                                       == limbs.CUDA_CORE
                                       else extra["other_route_ms"])
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": 0, "max_abs_err": 0,
               "ms": tot["ms"], "plain_ms": tot["plain_ms"],
               "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
               "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                            else "operations"),
               "library_ms": (tot["library_ms"] if name == "bin_bin_matmul"
                              else None),
               "shapes": detail}
        if name == "bin_bin_matmul":
            row["ms_at_library_shapes"] = tot["ms_library_shapes"]
        if name in limb_routes:   # the IMAD kernel at the same shapes
            row["imad_ms"] = tot["imad_ms"]
            print(f"[chip_smoke] {name} over MnistNet4's four shapes: "
                  f"{tot['ms']:.5f} ms, the IMAD kernel {tot['imad_ms']:.5f}"
                  f" ms ({tot['imad_ms'] / tot['ms']:.2f}x)")
        rows.append(row)
    return rows


def launched(kbuild) -> dict:
    return {k: v for k, v in kbuild.LAUNCHES.items() if v}


def per_dot_phase(kbuild) -> dict:
    """Phase 6: a secure fc layer of MnistNet4's width on the per-dot route
    (B5 only) == the same layer on cached weight limbs (B1)."""
    import torch
    from repro_torch.core import linear, prf
    from repro_torch.core.randomness import Parties
    from repro_torch.core.rss import reconstruct, share
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rss_matmul as dense

    g = torch.Generator().manual_seed(3)
    xf = torch.randn(BATCH, 3136, generator=g)
    wf = torch.randn(3136, 512, generator=g) * 0.02
    bf = torch.randn(512, generator=g) * 0.1
    x = share(xf.cuda(), prf.PRNGKey(11))
    w = share(wf.cuda(), prf.PRNGKey(12))
    b = share(bf.cuda(), prf.PRNGKey(13))
    wl = dense.precompute_weight_limbs(w.shares)
    parties = Parties.setup(prf.PRNGKey(14), device="cuda")
    # float64 on the fixed-point encodings: only the truncation's few ulp
    # separate it from the secure layer
    enc = lambda t: x.ring.encode(t).double() / x.ring.scale
    plain = (enc(xf) @ enc(wf) + enc(bf)).numpy()
    total = 0
    try:
        for fused in (True, False):
            linear.set_fused_rounds(fused)
            kbuild.reset_launches()
            want = reconstruct(linear.linear_layer(
                x, None, b, parties.fresh(), w_limbs=wl), decode=False)
            torch.cuda.synchronize()
            if launched(kbuild) != {"rss_matmul": 1}:
                fail(f"cached-limb layer launched {launched(kbuild)}")
            err = float(abs(x.ring.decode(want).cpu().double().numpy()
                            - plain).max())
            if not err < 0.005:
                fail(f"secure fc layer differs from float64 by {err}")
            for mode, per in (("opt2", 6), ("paper3", 9)):
                linear.set_matmul_mode(mode)
                kbuild.reset_launches()
                t0 = time.perf_counter()
                got = linear.linear_layer(x, w, b, parties.fresh(),
                                          dot=kops.rss_matmul_dot)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                counts = launched(kbuild)
                if counts != {"ring_matmul": per}:
                    fail(f"per-dot layer {mode} fused={fused}: launches "
                         f"{counts}, want ring_matmul {per}")
                if not torch.equal(reconstruct(got, decode=False), want):
                    fail(f"per-dot layer {mode} fused={fused} opens to "
                         f"another value than the cached-limb layer")
                total += per
                print(f"[chip_smoke] per-dot fc (32, 3136) x (3136, 512) "
                      f"{mode} fused={fused}: {per} B5 launches, {dt:.3f} "
                      f"ms host clock, == B1 layer (|err| vs float64 "
                      f"{err:.2e})")
    finally:
        linear.set_matmul_mode("opt2")
        linear.set_fused_rounds(True)
    return {"ring_matmul": total}


def binary_phase(kbuild) -> dict:
    """Phase 7: the binarized-product API at MnistNet4's layer shapes, held
    to float64 products on the card: B7 as a plaintext BNN layer (±1 x ±1),
    B6 as a public ±1-weight layer on each share of a secret."""
    import torch
    from repro_torch.core import prf
    from repro_torch.core.rss import RSS, reconstruct, share
    from repro_torch.kernels import ops as kops

    g = torch.Generator().manual_seed(5)
    kbuild.reset_launches()
    for m, k, n in MNIST4_SHAPES:
        a = (2 * torch.randint(0, 2, (m, k), dtype=torch.int8, generator=g)
             - 1).cuda()
        w = (2 * torch.randint(0, 2, (k, n), dtype=torch.int8, generator=g)
             - 1).cuda()
        want = a.double() @ w.double()
        if not torch.equal(kops.binary_binary_matmul_op(a, w).double(),
                           want):
            fail(f"binary layer ({m}, {k}, {n}) != float64 product")
        xf = torch.randn(m, k, generator=g).cuda()
        x = share(xf, prf.PRNGKey(m))
        z = torch.stack([kops.binary_weight_matmul_op(x.shares[i], w)
                         for i in range(3)])
        opened = reconstruct(RSS(z, x.ring), decode=False)
        want = x.ring.encode(xf).double() @ w.double()
        if not torch.equal(opened.double(), want):
            fail(f"public ±1-weight layer ({m}, {k}, {n}) != float64 "
                 f"product")
    torch.cuda.synchronize()
    counts = launched(kbuild)
    want = {"bin_bin_matmul": len(MNIST4_SHAPES),
            "bin_weight_matmul": 3 * len(MNIST4_SHAPES)}
    if counts != want:
        fail(f"binarized layers launched {counts}, want {want}")
    print(f"[chip_smoke] binarized layers at MnistNet4's shapes: == float64, "
          f"launches {counts}")
    return counts


def tuned_phase(kbuild, requests: dict, tmp: Path) -> dict:
    """Phase 5: the autotuner, the path solver and telemetry on the card.

    Tune: ``ensure_tuned`` over the kernel requests of every phase-3 path
    into a cache under ``tmp`` (each distinct padded launch once; every
    candidate equal to the plan's output bit for bit, or it raises); each
    B1/B3 launch prints the plan's config and time, the winner's and every
    candidate's.  Compile with the cache: MnistNet4 and CifarNet2, shared
    and public, served with the cache; every linear op carries its
    configs, and the logits equal the untuned run's bit for bit.  Solve:
    MnistNet1 and CifarNet2 under local / lan / wan, each layer's path
    printed, ``model.predicted`` == the live ledger, online and offline;
    with no deployment the ledger == PINNED.  Trace: serve_secure on
    CifarNet2 shared, batch 32, 4 queries, with --trace and --metrics-json:
    the trace passes the validator, the attribution's measured bytes sum
    to the ledger, the logits equal those with telemetry off, and q/s off
    and on are printed (alternating, two runs each).  Returns the served
    runs' launches."""
    import numpy as np
    import torch
    from repro_torch.core import cost_model, telemetry
    from repro_torch.kernels import autotune
    from repro_torch.launch import serve_secure
    from repro_torch.nn.bnn import INPUT_SHAPES

    cache = tmp / "autotune.json"
    reqs = [r for rs in requests.values() for r in rs]
    rows = {}

    def report(req, best, timings):
        family = req[0]
        plan = next(iter(timings))          # the plan's config comes first
        rows.setdefault(family, []).append(
            (req, plan, timings[plan], best, timings[best]))
        if family in ("rss_matmul", "bin_rss_matmul"):
            cands = "; ".join(f"{c.describe()} {us:.2f}"
                              for c, us in timings.items())
            print(f"[chip_smoke] tune {family} m={req[1]} k={req[2]} "
                  f"n={req[3]} L={req[4]}: plan {plan.describe()} "
                  f"{timings[plan]:.2f} us, best {best.describe()} "
                  f"{timings[best]:.2f} us "
                  f"({timings[plan] / timings[best]:.2f}x); measured: "
                  f"{cands}")

    t0 = time.perf_counter()
    try:
        tuned = autotune.ensure_tuned(reqs, smoke=True, cache_path=cache,
                                      device="cuda", on_tuned=report)
    except RuntimeError as e:
        fail(f"autotune: {e}")
    for family, rs in sorted(rows.items()):
        plan_us = sum(r[2] for r in rs)
        best_us = sum(r[4] for r in rs)
        moved = sum(r[1] != r[3] for r in rs)
        print(f"[chip_smoke] tune {family}: {len(rs)} launches, {moved} off "
              f"the plan, plan {plan_us:.2f} us, tuned {best_us:.2f} us")
    print(f"[chip_smoke] tuned {tuned} distinct launches of {len(reqs)} "
          f"requests in {time.perf_counter() - t0:.1f} s, every candidate "
          f"equal to the plan's output")

    launches = {name: 0 for name in kbuild.LAUNCHES}

    def served(**kw):
        kbuild.reset_launches()
        st = serve_secure.serve(batch=BATCH, device="cuda", **kw)
        for name, c in kbuild.LAUNCHES.items():
            launches[name] += c
        return st

    # compile with the cache: configs on every op, logits unchanged
    for net in ("MnistNet4", "CifarNet2"):
        for weights in WEIGHT_MODES:
            base = served(net=net, queries=1, weights=weights)
            st = served(net=net, queries=1, weights=weights,
                        deployment="lan", autotune_cache=cache)
            for i, op in enumerate(st["model"].ops):
                if op["op"] in ("conv", "sepconv", "fc"):
                    parts = op["w" if weights == "shared" else "pub_w"]
                    kc = op.get("kcfg")
                    if kc is None or len(kc) != len(parts) \
                            or any(c is None for c in kc):
                        fail(f"{net} {weights}: op {i} carries kcfg {kc}")
            if not np.array_equal(st["logits"], base["logits"]):
                fail(f"{net} {weights}: the tuned compile's logits differ "
                     f"from the untuned compile's")
            cfgs = sorted({c.describe() for op in st["model"].ops
                           for c in op.get("kcfg", ())})
            print(f"[chip_smoke] {net} {weights} compiled with the cache: "
                  f"configs {cfgs}; logits == untuned, bit for bit")

    # solve: the prediction at the deployment's batch == the live ledger
    for net in ("MnistNet1", "CifarNet2"):
        st = served(net=net, queries=1)
        got = tuple(getattr(st["ledger"], k) for k in
                    ("rounds", "nbytes", "pre_rounds", "pre_nbytes"))
        if got != PINNED[(net, "shared", "auto", True)]:
            fail(f"{net} with no deployment: ledger {got} != pinned")
        for dep in cost_model.DEPLOYMENTS:
            st = served(net=net, queries=1, deployment=dep)
            pred, led = st["model"].predicted, st["ledger"]
            want = (led.rounds, led.nbytes, led.pre_rounds, led.pre_nbytes)
            have = (pred.rounds, pred.nbytes, pred.pre_rounds,
                    pred.pre_nbytes)
            if have != want:
                fail(f"{net} {dep}: predicted {have} != ledger {want}")
            paths = ", ".join(f"{e.name}={e.path}" for e in pred.entries
                              if e.name.startswith("l"))
            print(f"[chip_smoke] solve {net} {dep}: {paths}; predicted == "
                  f"ledger {want}")

    # trace: serve_secure with telemetry, against runs without
    shape = (BATCH,) + INPUT_SHAPES["CifarNet2"]
    qps = {"off": [], "on": []}
    trace, metrics = tmp / "trace.json", tmp / "metrics.json"
    for turn in ("off", "on", "off", "on"):
        kbuild.reset_launches()
        if turn == "off":
            st = serve_secure.serve("CifarNet2", BATCH, QUERIES,
                                    device="cuda")
            off = st
        else:
            st = serve_secure.main(
                ["--net", "CifarNet2", "--batch", str(BATCH), "--queries",
                 str(QUERIES), "--trace", str(trace), "--metrics-json",
                 str(metrics)])
            tr = json.loads(trace.read_text())
            try:
                telemetry.validate_chrome_trace(tr)
            except ValueError as e:
                fail(f"trace: {e}")
            rep, led = st["attribution"], st["ledger"]
            if sum(r.meas_bytes for r in rep.rows) != led.nbytes \
                    or sum(r.meas_rounds for r in rep.rows) != led.rounds \
                    or not rep.exact:
                fail("trace: the attribution does not sum to the ledger")
            if not np.array_equal(st["logits"], off["logits"]):
                fail("trace: logits with telemetry on differ from off")
            dev_ms = [e["args"]["device_ms"] for e in tr["traceEvents"]
                      if e["ph"] == "X" and e["name"].startswith("query[")]
            if len(dev_ms) != QUERIES:
                fail(f"trace: {len(dev_ms)} query spans with device time")
        for name, c in kbuild.LAUNCHES.items():
            launches[name] += c
        qps[turn].append(st["query_per_s"])
    m = json.loads(metrics.read_text())
    print(f"[chip_smoke] trace CifarNet2 shared batch {BATCH}: valid, "
          f"{len(tr['traceEvents'])} events, query device ms "
          f"{[round(v, 3) for v in dev_ms]}, query latency p50 "
          f"{m['histograms']['query_latency_seconds']['p50'] * 1e3:.2f} ms; "
          f"attribution == ledger; logits on == off")
    print(f"[chip_smoke] CifarNet2 shared q/s telemetry off {qps['off']} / "
          f"on {qps['on']} (alternating runs of {QUERIES} queries)")
    return launches


def offline_verify_phase(kbuild) -> dict:
    """Phase 6: the tape pool and the verified runtime on the card (see
    the module docstring).  Returns the phase's kernel launches."""
    import numpy as np
    import torch
    from repro_torch.core import integrity, prf, transport
    from repro_torch.core import preprocessing as prep
    from repro_torch.core.randomness import Parties
    from repro_torch.core.ring import RING32
    from repro_torch.core.rss import share
    from repro_torch.core.secure_model import secure_infer
    from repro_torch.launch import serve_secure
    from repro_torch.nn.bnn import INPUT_SHAPES

    launches = {name: 0 for name in kbuild.LAUNCHES}

    def add_launches():
        for name, c in kbuild.LAUNCHES.items():
            launches[name] += c

    def inputs(net, batch, device):
        """serve()'s own input, its shares and party keys (seed 0)."""
        x = np.random.default_rng(0).integers(
            0, 2, (batch,) + INPUT_SHAPES[net]).astype(np.float32) - 0.5
        xs = share(torch.as_tensor(x, device=device), prf.PRNGKey(3),
                   RING32)
        return xs, Parties.setup(prf.PRNGKey(7)).keys

    # every online query the serving runners make reports the threefry
    # evaluations it ran (warm-up, timed and profiled queries)
    calls, per_query = [0], []
    real_tf = prf._threefry_tensor
    real_makers = (serve_secure.make_runner, serve_secure.make_tape_runner)

    def counted_tf(*a):
        calls[0] += 1
        return real_tf(*a)

    def counting(make):
        def make_counted(*a, **kw):
            run = make(*a, **kw)

            def counted_run(*args):
                c0 = calls[0]
                out = run(*args)
                per_query.append(calls[0] - c0)
                return out
            counted_run.verifier = run.verifier
            return counted_run
        return make_counted

    prf._threefry_tensor = counted_tf
    serve_secure.make_runner = counting(real_makers[0])
    serve_secure.make_tape_runner = counting(real_makers[1])
    try:
        # -- the tape pool ---------------------------------------------------
        base = {}
        for net, weights in POOL_NETS:
            shape = (BATCH,) + INPUT_SHAPES[net]
            what = f"{net} {weights}"
            kbuild.reset_launches()
            per_query.clear()
            inline = serve_secure.serve(net, BATCH, POOL_QUERIES,
                                        device="cuda", weights=weights,
                                        profile=True)
            prf_inline = list(per_query)
            per_query.clear()
            pool = serve_secure.serve(net, BATCH, POOL_QUERIES,
                                      device="cuda", weights=weights,
                                      offline="pool", pool_depth=POOL_DEPTH,
                                      profile=True)
            prf_pool = list(per_query)
            add_launches()
            base[(net, weights)] = inline
            if len(prf_pool) != POOL_QUERIES + 2 or any(prf_pool):
                fail(f"{what} pool: threefry calls per online query "
                     f"{prf_pool}, want {POOL_QUERIES + 2} zeros")
            if len(prf_inline) != POOL_QUERIES + 2 or min(prf_inline) < 1:
                fail(f"{what} inline: threefry calls per query {prf_inline}")
            on_rows = {t: tuple(v) for t, v in inline["ledger"].by_tag.items()
                       if not t.startswith("pre:")}
            if {t: tuple(v) for t, v in pool["ledger"].by_tag.items()} \
                    != on_rows:
                fail(f"{what}: the tape-backed ledger is not the inline "
                     f"ledger's online rows")
            ledgers = [tuple(st[k] for k in ("online_rounds", "online_bytes",
                                             "offline_rounds",
                                             "offline_bytes"))
                       for st in (inline, pool)]
            if ledgers[0] != ledgers[1] \
                    or ledgers[0] != PINNED[(net, weights, "auto", True)]:
                fail(f"{what}: ledgers {ledgers} != pinned")
            # tape == inline bit for bit at the same session keys, through
            # the served model on the card
            model = pool["model"]
            spec = prep.trace_material(model, shape)
            xs, keys = inputs(net, BATCH, "cuda")
            tape = prep.generate_tape(spec, [keys], device="cuda")
            out = prep.make_tape_infer(model, spec)(keys, xs.shares,
                                                    tape.query_slice(0))
            if not np.array_equal(out.float().cpu().numpy(),
                                  inline["logits"]):
                fail(f"{what}: tape-backed logits differ from inline ones "
                     f"at the same keys")
            # the plant a buffer: all four queries in one draw an item,
            # against one query at a time, in turns
            gen = prep.make_tape_generator(spec, "cuda")
            keys4 = prep.tape_session_keys(prf.PRNGKey(100), POOL_DEPTH)
            plant = {"batched": [], "one by one": []}
            for turn in ("batched", "one by one", "one by one", "batched"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if turn == "batched":
                    gen(keys4)
                else:
                    for k in keys4:
                        gen([k])
                torch.cuda.synchronize()
                plant[turn].append(round((time.perf_counter() - t0) * 1e3,
                                         1))
            pi, pp = inline["profile"], pool["profile"]
            print(f"[chip_smoke] pool {what} batch {BATCH} depth "
                  f"{POOL_DEPTH}, {POOL_QUERIES} queries: online-only "
                  f"{pool['query_per_s_online']:.3f} q/s, amortised "
                  f"{pool['query_per_s']:.3f} q/s, inline "
                  f"{inline['query_per_s']:.3f} q/s; tape "
                  f"{pool['tape_mb_per_query']:.3f} MB a query "
                  f"({spec.summary()}); plant "
                  f"{pool['plant_ms_per_buffer']:.1f} ms a buffer of "
                  f"{POOL_DEPTH} in the pool, {plant} ms in turns; "
                  f"{pool['refills']} refills; online "
                  f"{pool['online_seconds'] / POOL_QUERIES * 1e3:.2f} ms "
                  f"a query; device kernels a query "
                  f"inline {pi['device_kernels']} (busy "
                  f"{100 * pi['busy_share']:.1f}%) vs tape-backed "
                  f"{pp['device_kernels']} (busy "
                  f"{100 * pp['busy_share']:.1f}%); threefry calls a query "
                  f"inline {prf_inline[1]}, tape-backed 0; tape == inline "
                  f"at the same keys")
        # one query's tape on the card == on the CPU
        for net, batch in (("MnistNet1", BATCH), ("CifarNet2", 2)):
            model = serve_secure.build(net, device="cuda")
            spec = prep.trace_material(model, (batch,) + INPUT_SHAPES[net])
            keys = Parties.setup(prf.PRNGKey(7)).keys
            card = prep.generate_tape(spec, [keys], device="cuda")
            host = prep.generate_tape(spec, [keys], device="cpu")
            for k, v in card.slabs.items():
                if not torch.equal(v.cpu(), host.slabs[k]):
                    fail(f"{net} batch {batch}: tape slab {k} on the card "
                         f"differs from the CPU's")
            print(f"[chip_smoke] {net} batch {batch}: tape on the card == "
                  f"CPU ({len(card.slabs)} slabs, {card.nbytes:,} B)")

        # -- the verified runtime --------------------------------------------
        ref = base[("CifarNet2", "shared")]
        rates = {"off": [], "opens": [], "full": []}
        ops = {}
        for mode in ("off", "opens", "full", "full", "opens", "off"):
            kbuild.reset_launches()
            st = serve_secure.serve("CifarNet2", BATCH, POOL_QUERIES,
                                    device="cuda", verify=mode)
            add_launches()
            if not np.array_equal(st["logits"], ref["logits"]):
                fail(f"CifarNet2 verify={mode}: logits differ from the "
                     f"unverified run")
            rates[mode].append(round(st["query_per_s"], 3))
            ops[mode] = st.get("verified_ops", 0)
        print(f"[chip_smoke] CifarNet2 shared batch {BATCH}, {POOL_QUERIES} "
              f"queries a run, in turns: q/s {rates}; verified ops a query "
              f"{ops}; logits == unverified")
        # the 12-cell fault matrix, card against CPU
        runs = {}
        for dev in ("cpu", "cuda"):
            runs[dev] = (serve_secure.build("MnistNet1", device=dev),
                         *inputs("MnistNet1", BATCH, dev))
        kbuild.reset_launches()
        cells = []
        for op, party in FAULT_OPS:
            for mode in FAULT_MODES:
                got = {}
                for dev, (model, xs, keys) in runs.items():
                    ft = integrity.FaultInjectingTransport(
                        transport.LocalTransport(),
                        [integrity.Fault(op, 0, mode, party)])
                    v = integrity.Verifier("full")
                    with transport.use_transport(ft), \
                            integrity.verify_scope(v):
                        secure_infer(model, xs, Parties(keys, device=dev))
                        report = v.traced_report()
                    try:
                        v.check(report)
                    except integrity.IntegrityError as e:
                        got[dev] = (e.op, e.index, e.tag, e.round, e.party)
                    else:
                        fail(f"fault {op}/{mode} on {dev}: not caught "
                             f"(fired {ft.fired})")
                if got["cuda"] != got["cpu"] or got["cuda"][0] != op:
                    fail(f"fault {op}/{mode}: card {got['cuda']} vs CPU "
                         f"{got['cpu']}")
                cells.append(f"{op}/{mode}->{got['cuda']}")
        add_launches()
        print(f"[chip_smoke] fault matrix MnistNet1 batch {BATCH} "
              f"(verify full): 12 of 12 caught, card == CPU fields: "
              + "; ".join(cells))
    finally:
        prf._threefry_tensor = real_tf
        serve_secure.make_runner, serve_secure.make_tape_runner = \
            real_makers
    return launches


def _row(name, ms, pms, b_ms, o_ms, lib, err, detail) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "library_ms": lib, "shapes": detail}


def check_flash() -> dict:
    """Phase 8, B8: kernel == plain version (host CPU) at FLASH_SHAPES; the
    row's numbers are TinyLlama's shape (the last), the main path's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_ref

    g = torch.Generator().manual_seed(7)
    detail, err_max = [], 0.0
    for b, s, h, hkv, hd, dtype in FLASH_SHAPES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((b, s, n, hd), generator=g).to(dt)
                   for n in (h, hkv, hkv))
        qd, kd, vd = q.cuda(), k.cuda(), v.cuda()
        run = lambda: kops.flash_attention_op(qd, kd, vd)
        got = run().cpu().float()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = flash_attention_ref(q, k, v).float()
        pms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        if dtype == "float32":
            ok = err < 2e-5                  # the reference's tolerance
        else:   # one bf16 rounding of float32 values that agree to ~1e-6
            ok = bool(((got - want).abs()
                       <= 2.0 ** -7 * want.abs() + 1e-5).all())
        if not ok:
            fail(f"flash_attention {(b, s, h, hkv, hd, dtype)}: kernel != "
                 f"plain version (max abs err {err})")
        err_max = max(err_max, err)
        ms = median_ms(run)
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))
        lib = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        size = q.element_size()
        b_ms = size * (2 * q.numel() + 2 * k.numel()) / HBM_BPS * 1e3
        ops = 4 * b * h * hd * s * (s + 1) // 2    # the causal triangle
        o_ms = ops / (BF16_OPS if dtype == "bfloat16" else FP32_OPS) * 1e3
        detail.append({"B": b, "S": s, "H": h, "Hkv": hkv, "hd": hd,
                       "dtype": dtype, "ms": ms, "plain_ms": pms,
                       "bound_ms": max(b_ms, o_ms), "library_ms": lib,
                       "max_abs_err": err})
        print(f"[chip_smoke] flash_attention {(b, s, h, hkv, hd)} {dtype}: "
              f"{ms:.5f} ms (bound {max(b_ms, o_ms):.5f} ms, "
              f"{100 * max(b_ms, o_ms) / ms:.1f}% of bound), plain on host "
              f"{pms:.3f} ms, sdpa {lib:.5f} ms ({ms / lib:.1f}x), max |err| "
              f"{err:.3g}")
    return _row("flash_attention", ms, pms, b_ms, o_ms, lib, err_max,
                detail)


def mamba_layer_inputs(cfg, params, tokens):
    """The scan's inputs of layer 0 of a full-width Mamba2 on ``tokens``:
    (x, B, C, da, dt) in float32, as the reference's module test takes
    them."""
    import torch
    from repro_torch.nn import ssm
    from repro_torch.nn.layers import apply_norm, embed
    with torch.no_grad():
        lp = params.layers[0]
        hin = apply_norm(cfg.norm, lp.norm1, embed(params.embed, tokens))
        _, x, bm, cm, da, dt = ssm.ssd_inputs(lp.mamba, hin, cfg)
    return tuple(t.float() for t in (x, bm, cm, da, dt))


def ssd_diagnosis(ssd, dev, got, want, f64, chunk: int, tol: float) -> str:
    """What a failed B9 comparison prints beside its error: which side
    drifts from float64, the (batch, chunk, head) cells past the tolerance,
    the serial kernel's error on the same inputs, and the card."""
    bad = ((got - want).abs() > tol).nonzero()
    cells = sorted({(int(i), int(j) // chunk, int(k))
                    for i, j, k, _ in bad.tolist()})
    serial = float((ssd._launch(*dev, chunk, "serial").cpu()
                    - want).abs().max())
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,uuid,serial",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (f"vs float64 / max |y|: kernel {f64['kernel']:.3g}, plain "
            f"{f64['plain']:.3g}; {len(bad)} elements in (batch, chunk, "
            f"head) cells {cells[:16]}; serial kernel max abs err "
            f"{serial}; card {r.stdout.strip()}")


def check_ssd(layer_inputs) -> dict:
    """Phase 8, B9: kernel == plain version (host CPU) at the reference's
    test shapes and at Mamba2-1.3B's layer inputs at batch 1 and 2 (the
    row's numbers), each beside the serial kernel; at the layer shapes each
    pass is also timed alone."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.nn.ssm import CHUNK

    g = torch.Generator().manual_seed(8)
    cases = []
    for b, s, h, hd, n, chunk in SSD_SHAPES:
        cases.append(((torch.randn((b, s, h, hd), generator=g) * 0.5,
                       torch.randn((b, s, n), generator=g) * 0.5,
                       torch.randn((b, s, n), generator=g) * 0.5,
                       -torch.rand((b, s, h), generator=g) * 0.5,
                       torch.rand((b, s, h), generator=g) * 0.9 + 0.1),
                      chunk, SSD_REPEATS))
    layer = tuple(t.cpu() for t in layer_inputs)
    # Mamba2's layer at batch 1, then at batch 2 (the row's numbers)
    cases.append((tuple(t[:1].contiguous() for t in layer), CHUNK, 5))
    cases.append((layer, CHUNK, 5))
    detail, err_max = [], 0.0
    for host, chunk, reps in cases:
        dev = tuple(t.cuda() for t in host)
        run = lambda: ssd.ssd_scan(*dev, chunk=chunk)
        got = run()
        # the kernel's sums run in a fixed order: a repeat that differs in
        # any bit is a race between its threads
        (b, s, h, hd), n = host[0].shape, host[1].shape[-1]
        for _ in range(reps):
            if not torch.equal(run(), got):
                fail(f"ssd_scan {(b, s, h, hd, n, chunk)}: repeats of one "
                     f"launch differ")
        got = got.cpu()
        t0 = time.perf_counter()
        want = ssd.ssd_scan_ref(*host, chunk=chunk)
        pms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # each float32 side against the same math in float64: which one
        # drifts (printed, not gated)
        exact = ssd.ssd_chunked(*host, chunk, dtype=torch.float64)[0]
        f64 = {side: float((t.double() - exact).abs().max()) / scale
               for side, t in (("kernel", got), ("plain", want))}
        if not err <= SSD_REL_TOL * scale:
            fail(f"ssd_scan {(b, s, h, hd, n, chunk)}: kernel != plain "
                 f"version (max abs err {err}, max |y| {scale}); "
                 + ssd_diagnosis(ssd, dev, got, want, f64, chunk,
                                 SSD_REL_TOL * scale))
        err_max = max(err_max, err)
        ms = median_ms(run)
        # the serial kernel (one block per (head, batch) walks the chunks)
        old_run = lambda: ssd._launch(*dev, chunk, "serial")
        old_err = float((old_run().cpu() - want).abs().max())
        if not old_err <= SSD_REL_TOL * scale:
            fail(f"ssd_scan {(b, s, h, hd, n, chunk)}: the serial kernel != "
                 f"plain version (max abs err {old_err})")
        old_ms = median_ms(old_run, reps=10)
        passes = {}
        if chunk == CHUNK:   # each pass alone, on buffers the others fill
            buf = ssd.scratch(b, s, h, hd, n, chunk, dev[0].device)
            for mode in ("gram", "states", "pass", "scan"):
                passes[mode] = median_ms(
                    lambda: ssd._launch(*dev, chunk, mode, buf))
        b_ms = 4 * (2 * b * s * h * hd + 2 * b * s * n + 2 * b * s * h) \
            / HBM_BPS * 1e3
        # per (b, chunk): the causal triangle of C·Bᵀ (B and C are shared
        # across heads); per (b, h, chunk): its decayed product with x·dt,
        # the carried-state term and the state update
        tri = chunk * (chunk + 1) // 2
        ops = 2 * b * (s // chunk) * (tri * n + h * (tri * hd
                                                      + 2 * chunk * n * hd))
        o_ms = ops / FP32_OPS * 1e3
        detail.append({"B": b, "S": s, "H": h, "hd": hd, "N": n,
                       "chunk": chunk, "ms": ms, "plain_ms": pms,
                       "bound_ms": max(b_ms, o_ms), "max_abs_err": err,
                       "max_abs_y": scale, "repeats": reps,
                       "serial_ms": old_ms, "pass_ms": passes,
                       "rel_err_vs_float64": f64})
        print(f"[chip_smoke] ssd_scan {(b, s, h, hd, n)} chunk {chunk}: "
              f"{ms:.5f} ms (bound {max(b_ms, o_ms):.5f} ms, "
              f"{100 * max(b_ms, o_ms) / ms:.1f}% of bound), plain on host "
              f"{pms:.3f} ms, max |err| {err:.3g} (max |y| {scale:.3g}; "
              f"vs float64 / max |y|: kernel {f64['kernel']:.3g}, plain "
              f"{f64['plain']:.3g}); "
              f"{reps} repeats bit-identical; serial kernel {old_ms:.5f} ms "
              f"({old_ms / ms:.1f}x)"
              + "".join(f"; {k} {v:.5f} ms" for k, v in passes.items()))
    # no single PyTorch call computes the SSD scan
    row = _row("ssd_scan", ms, pms, b_ms, o_ms, None, err_max, detail)
    row["serial_ms"], row["pass_ms"] = old_ms, passes
    return row


def lm_tokens(vocab: int):
    import torch
    return torch.randint(0, vocab, (LM_BATCH, LM_SEQ),
                         generator=torch.Generator().manual_seed(1)).cuda()


def print_serve(st) -> None:
    if st["tokens"].shape != (SERVE["batch"], SERVE["gen"]):
        fail(f"{st['arch']} served tokens of shape {st['tokens'].shape}")
    print(f"[chip_smoke] serve {st['arch']} batch {st['batch']} prompt "
          f"{st['prompt_len']} gen {st['gen']} on {st['kind']}: prefill "
          f"{st['prefill_tok_s']:.1f} tok/s ({st['prefill_s']:.4f} s), "
          f"decode {st['decode_tok_s']:.1f} tok/s ({st['decode_s']:.4f} s), "
          f"peak memory {st['peak_mem_bytes'] / 2**30:.3f} GiB")


def tinyllama_phase(kbuild, params, cfg) -> dict:
    """Phase 9: TinyLlama-1.1B's prefill step on B8 (22 launches) == the
    _sdpa route; then serve."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step

    batch = {"tokens": lm_tokens(cfg.vocab)}
    routes = {"sdpa": make_prefill_step(cfg),
              "flash": make_prefill_step(cfg,
                                         flash_impl=kops.flash_attention_op)}
    out, secs = {}, {}
    for name, step in routes.items():
        step(params, batch)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        out[name] = step(params, batch).float()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        counts = launched(kbuild)
        want = {"flash_attention": cfg.n_layers} if name == "flash" else {}
        if counts != want:
            fail(f"TinyLlama prefill ({name}) launched {counts}, want {want}")
        print(f"[chip_smoke] TinyLlama-1.1B prefill step {LM_BATCH}x{LM_SEQ} "
              f"({name} route): {secs[name]:.4f} s = "
              f"{LM_BATCH * LM_SEQ / secs[name]:.0f} tok/s, launches "
              f"{counts}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    got, want = out["flash"], out["sdpa"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if got.shape != (LM_BATCH, cfg.vocab) or not torch.isfinite(got).all() \
            or not err <= LM_TOL * scale:
        fail(f"TinyLlama prefill: flash route differs from the _sdpa route "
             f"by {err} (logits scale {scale})")
    print(f"[chip_smoke] TinyLlama-1.1B last-position logits: flash route vs "
          f"_sdpa route max |err| {err:.4g} of scale {scale:.4g}")
    print_serve(serve("tinyllama-1.1b", device="cuda", params=params,
                      **SERVE))
    return {"flash_attention": cfg.n_layers}


def mamba_phase(kbuild, params, cfg) -> dict:
    """Phase 9: Mamba2-1.3B's 2 x 2048 prefill layer by layer, each scan on
    B9 (48 launches) and held to ssd_prefill's output; then serve."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.launch.serve import serve
    from repro_torch.nn import ssm
    from repro_torch.nn.layers import apply_norm, embed

    tokens = lm_tokens(cfg.vocab)
    errs = []
    kbuild.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        h = embed(params.embed, tokens)
        for lp in params.layers:
            hin = apply_norm(cfg.norm, lp.norm1, h)
            z, x, bm, cm, da, dt = ssm.ssd_inputs(lp.mamba, hin, cfg)
            y = ssd.ssd_scan(x.float(), bm.float(), cm.float(), da, dt,
                             chunk=ssm.CHUNK)
            got = ssm.ssd_output(lp.mamba, y, x, z, cfg).float()
            want, _ = ssm.ssd_prefill(lp.mamba, hin, cfg)
            errs.append((float((got - want.float()).abs().max()),
                         float(want.float().abs().max())))
            h = h + want
        h = apply_norm(cfg.norm, params.final_norm, h)
        logits = h[:, -1] @ params.embed.T.to(h.dtype)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launched(kbuild)
    if counts != {"ssd_scan": cfg.n_layers}:
        fail(f"Mamba2 prefill launched {counts}, want ssd_scan "
             f"{cfg.n_layers}")
    worst = max(e / sc for e, sc in errs)
    if not worst <= SSD_LAYER_TOL or not torch.isfinite(logits).all():
        fail(f"Mamba2 prefill: a layer on B9 differs from ssd_prefill by "
             f"{worst:.4g} of its scale")
    print(f"[chip_smoke] Mamba2-1.3B prefill {LM_BATCH}x{LM_SEQ}, "
          f"{cfg.n_layers} layers, "
          f"each on B9 and on ssd_prefill: {secs:.3f} s, launches {counts}, "
          f"worst layer max |err| {worst:.3g} of its scale")
    print_serve(serve("mamba2-1.3b", device="cuda", params=params, **SERVE))
    return {"ssd_scan": cfg.n_layers}


# ---------------------------------------------------------------------------
# 11. the secure LM
# ---------------------------------------------------------------------------

def check_secure_lm_kernels(rows: list) -> dict:
    """Phase 11 (kernels): the batched B5 at the decode step's shapes at
    buckets 16 and 64 == its plain version on CPU copies, bit for bit and
    on repeats, both routes and the split pass too; timed beside the 2-D
    entry looped over the batch.  B1 at its decode shapes (M = 1) == its
    plain version, timed; the B1 row gains the sum a token.  Returns the
    batched B5's row."""
    import torch
    from repro_torch.kernels import limbs
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ring_matmul as ringmm
    from repro_torch.kernels import rss_matmul as dense

    sms = limbs.sm_count(torch.device("cuda"))
    g = torch.Generator().manual_seed(11)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=g)

    hd = SLM["d"] // SLM["heads"]
    detail, tot = [], {"ms": 0.0, "plain_ms": 0.0, "b": 0.0, "o": 0.0}
    main_bucket = min(b for b in SLM_SERVE["buckets"]
                      if b >= SLM_SERVE["prompt_len"] + SLM_SERVE["gen"])
    for bucket in SLM_SERVE["buckets"]:
        # _bmm doubles K: [x_i | x_{i+1}] . [y_i + y_{i+1}; y_i]
        for what, (m, k, n) in (("q.K^T", (1, 2 * hd, bucket)),
                                ("probs.V", (1, 2 * bucket, hd))):
            bt = B5_BATCH
            a, b = words(bt, m, k), words(bt, k, n)
            ad, bd = a.cuda(), b.cuda()
            run = lambda: kops.ring_matmul_batched_op(ad, bd)
            got = run()
            torch.cuda.synchronize()
            want = ringmm.ring_matmul_batched_ref(a, b)
            if not torch.equal(got.cpu(), want):
                fail(f"ring_matmul_batched {what} bucket {bucket}: kernel "
                     f"!= plain version")
            for _ in range(SPLIT_REPEATS):
                if not torch.equal(run(), got):
                    fail(f"ring_matmul_batched {what} bucket {bucket}: "
                         f"repeats differ")
            if not torch.equal(ringmm.split_weight_limbs_batched(bd).cpu(),
                               ringmm.ring_weight_limbs_batched_ref(b)):
                fail(f"ring_matmul_batched {what}: the split pass != its "
                     f"plain version")
            plan = limbs.limb_mma_plan(bt, m, k, n, sms)
            alt = (limbs.CUDA_CORE if plan[0] == limbs.TENSOR_CORE
                   else limbs.TENSOR_CORE)
            if not torch.equal(ringmm._launch_batched(ad, bd, alt).cpu(),
                               want):
                fail(f"ring_matmul_batched {what}: the {alt} route != "
                     f"plain version")
            ms = median_ms(run)
            alt_ms = median_ms(lambda: ringmm._launch_batched(ad, bd, alt))
            loop_ms = median_ms(lambda: [kops.ring_matmul_op(ad[i], bd[i])
                                         for i in range(bt)], reps=10)
            pms = host_ms(lambda: ringmm.ring_matmul_batched_ref(a, b))
            b_ms = 4 * bt * (m * k + k * n + m * n) / HBM_BPS * 1e3
            o_ms = 2 * RING_DOTS["ring_matmul"] * bt * m * k * n \
                / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({"what": what, "bucket": bucket, "Bt": bt, "M": m,
                           "K": k, "N": n, "ms": ms, "plain_ms": pms,
                           "bound_ms": bound, "limb_route": plan[0],
                           "splits": plan[2], "other_route_ms": alt_ms,
                           "loop_2d_ms": loop_ms})
            print(f"[chip_smoke] ring_matmul_batched {what} bucket {bucket} "
                  f"({bt}, {m}, {k}, {n}): {ms:.5f} ms ({plan[0]}, split-K "
                  f"{plan[2]}, {SPLIT_REPEATS} repeats bit-identical; "
                  f"{alt} {alt_ms:.5f} ms), bound {bound:.5f} ms (bytes "
                  f"{b_ms:.5f}), the 2-D entry looped over the batch "
                  f"{loop_ms:.4f} ms ({loop_ms / ms:.1f}x), plain on host "
                  f"{pms:.3f} ms, exact")
            if bucket == main_bucket:
                tot["ms"] += ms
                tot["plain_ms"] += pms
                tot["b"] += b_ms
                tot["o"] += o_ms
    # torch has no integer batched product on CUDA: no library column
    brow = _row("ring_matmul_batched", tot["ms"], tot["plain_ms"], tot["b"],
                tot["o"], None, 0, detail)

    # B1 at the decode shapes, M = 1 (3 parties)
    dec, ms_tok, bound_tok = [], 0.0, 0.0
    for (k, n), per_tok in B1_DECODE.items():
        x = words(3, 1, k)
        wl = dense.precompute_weight_limbs(words(3, k, n).cuda())
        xd = x.cuda()
        run = lambda: dense.rss_matmul_parts(xd, wl)
        got = run()
        torch.cuda.synchronize()
        want = (torch.matmul(x, wl.wf.cpu())
                + torch.matmul(torch.roll(x, -1, 0), wl.ws.cpu()))
        if not torch.equal(got.cpu(), want):
            fail(f"rss_matmul decode shape (1, {k}, {n}): kernel != plain "
                 f"version")
        plan = limbs.limb_mma_plan(3, 1, k, n, sms)
        if plan[2] > 1:
            for _ in range(SPLIT_REPEATS):
                if not torch.equal(run(), got):
                    fail(f"rss_matmul decode shape (1, {k}, {n}): repeats "
                         f"differ")
        ms = median_ms(run)
        # x and out words once, the cached limbs (24 B a weight element)
        b_ms = (4 * 3 * (k + n) + 24 * k * n) / HBM_BPS * 1e3
        o_ms = 2 * 20 * 3 * k * n / INT8_OPS * 1e3
        dec.append({"M": 1, "K": k, "N": n, "ms": ms,
                    "bound_ms": max(b_ms, o_ms), "launches_per_token":
                    per_tok, "limb_route": plan[0], "splits": plan[2]})
        ms_tok += ms * per_tok
        bound_tok += max(b_ms, o_ms) * per_tok
        print(f"[chip_smoke] rss_matmul decode (3, 1, {k}) x ({k}, {n}): "
              f"{ms:.5f} ms ({plan[0]}, split-K {plan[2]}), bound "
              f"{max(b_ms, o_ms):.5f} ms ({100 * max(b_ms, o_ms) / ms:.1f}%)"
              f", {per_tok} a token, exact")
        del wl
    torch.cuda.empty_cache()
    b1 = next(r for r in rows if r["name"] == "rss_matmul")
    b1.update(decode_shapes=dec, decode_ms_per_token=ms_tok,
              decode_bound_ms_per_token=bound_tok)
    print(f"[chip_smoke] rss_matmul a decode token at {SLM_BLOCKS} blocks: "
          f"{ms_tok:.4f} ms, bound {bound_tok:.4f} ms "
          f"({100 * bound_tok / ms_tok:.1f}%)")
    return brow


def secure_lm_phase(kbuild) -> dict:
    """Phase 11 (serving): serve_lm at SLM's widths and SLM_BLOCKS blocks on
    the card (its ledger == lm_step_cost, or it raises), launching only B1
    and the batched B5; prints the rates, memory, launches and threefry
    calls a step, and the logits' gap to the fp32 oracle (reported, not
    gated: the fixed point's Newton envelope at this width is a finding
    about the reference).  Returns the run's launches."""
    import numpy as np
    import torch
    from repro_torch.core import prf
    from repro_torch.core.secure_transformer import plaintext_lm_forward
    from repro_torch.launch.serve_secure import serve_lm

    calls = [0]
    real_tf = prf._threefry_tensor

    def counted_tf(*a):
        calls[0] += 1
        return real_tf(*a)

    torch.cuda.empty_cache()
    prf._threefry_tensor = counted_tf
    try:
        kbuild.reset_launches()
        st = serve_lm(**SLM, blocks=SLM_BLOCKS, **SLM_SERVE, device="cuda")
        counts = launched(kbuild)
    finally:
        prf._threefry_tensor = real_tf
    q, p, n = SLM_SERVE["queries"], SLM_SERVE["prompt_len"], SLM_SERVE["gen"]
    steps = (q + 1) * (p + n - 1)          # the warm-up and timed ones
    want = {"rss_matmul": steps * (6 * SLM_BLOCKS + 1),
            "ring_matmul_batched": steps * 2 * SLM_BLOCKS}
    if counts != want:
        fail(f"secure LM served with launches {counts}, want {want}")
    lg = st["logits"]
    seq = st["prompt_tokens"] + st["tokens"][:-1]
    if lg.shape != (p + n - 1, SLM["vocab"]) or not np.isfinite(lg).all():
        fail(f"secure LM logits of shape {lg.shape} are not finite")
    oracle = plaintext_lm_forward(st["plain"], np.asarray(seq, np.int32),
                                  SLM["heads"], True, st["bucket"])
    gap = float(np.abs(lg - oracle).max() / np.abs(oracle).max())
    top1 = float((lg.argmax(-1) == oracle.argmax(-1)).mean())
    print(f"[chip_smoke] secure LM d {SLM['d']} heads {SLM['heads']} d_ff "
          f"{SLM['d_ff']} vocab {SLM['vocab']} blocks {SLM_BLOCKS} (the "
          f"reference's secure block: MHA, ReLU FFN, no RoPE) on "
          f"{st['kind']}, bucket {st['bucket']}: setup {st['setup_s']:.2f} s,"
          f" prefill {st['prefill_s']:.3f} s a prompt of {p}, decode "
          f"{st['decode_tok_per_s']:.4f} tok/s, {st['tok_per_s']:.4f} tok/s "
          f"over {q} generations of {n}; {st['comm_kb_per_token']:.3f} KB "
          f"and {st['rounds_per_token']} rounds a token (== lm_step_cost); "
          f"peak memory {st['peak_mem_bytes'] / 2**30:.3f} GiB; launches a "
          f"token {st['launches_per_token']}; threefry calls a step "
          f"{calls[0] / steps:.1f}; {st['traces']} build")
    print(f"[chip_smoke] secure LM logits vs plaintext_lm_forward: max |err| "
          f"{gap:.4g} of the oracle's scale, top-1 agreement "
          f"{top1:.3f} over {len(seq)} positions (reported, not gated)")
    return counts


def lm_on_host(lm):
    """The port's CPU copy of a card's SecureLMParams: the same shares, no
    limb caches (the CPU runs the plain products)."""
    import dataclasses
    from repro_torch.core.rss import RSS

    host = lambda r: RSS(r.shares.cpu(), r.ring)
    blocks = tuple(dataclasses.replace(
        b, limbs=None, **{f: host(getattr(b, f)) for f in b._FIELDS})
        for b in lm.blocks)
    return dataclasses.replace(lm, embed=host(lm.embed), blocks=blocks,
                               gf=host(lm.gf), w_out=host(lm.w_out),
                               w_out_limbs=None)


def secure_lm_card_vs_cpu() -> None:
    """Phase 11 (card == CPU): at SLM's widths and 2 blocks, a prompt of 4
    and 2 generated tokens under customized + RMSNorm, softmax + RMSNorm
    and customized + static norm: every step's logits and the final KV
    cache on the card == the port's CPU run, bit for bit.  Then one more
    customized + RMSNorm decode step on the card, timed and profiled (the
    profiler's cost grows with the step's ~30k kernels a block, so the
    served depth is not profiled here)."""
    import numpy as np
    import torch
    from repro_torch.core import prf
    from repro_torch.launch.profiling import profile_once
    from repro_torch.core.ring import RING32
    from repro_torch.core import secure_transformer as st

    c = SLM_CHECK
    card, _ = st.share_lm_params(prf.PRNGKey(1), SLM["vocab"], SLM["d"],
                                 SLM["heads"], SLM["d_ff"], c["blocks"],
                                 RING32, device="cuda")
    host = lm_on_host(card)
    keys = prf.split(prf.PRNGKey(7), 3)
    prompt = np.random.default_rng(0).integers(0, SLM["vocab"],
                                               c["prompt_len"])
    hd = SLM["d"] // SLM["heads"]
    for customized, static_norm in SLM_MODES:
        out = {}
        for dev, lm in (("cuda", card), ("cpu", host)):
            t0 = time.perf_counter()
            cache = st.init_kv_cache(c["blocks"], SLM["heads"], hd, 16,
                                     RING32, device=dev)
            lgs, cache = st.secure_prefill(lm, cache, prompt, keys,
                                           customized, static_norm)
            rows = [lgs.cpu()]
            tok = int(lgs[-1].argmax())
            for pos in range(c["prompt_len"],
                             c["prompt_len"] + c["gen"] - 1):
                lg, cache = st.secure_decode_step(lm, cache, tok, pos, keys,
                                                  customized, static_norm)
                rows.append(lg.cpu()[None])
                tok = int(lg.argmax())
            out[dev] = (torch.cat(rows), cache.k.cpu(), cache.v.cpu(),
                        time.perf_counter() - t0)
        what = (f"{'customized' if customized else 'softmax'} + "
                f"{'static norm' if static_norm else 'RMSNorm'}")
        for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
            if not torch.equal(a, b):
                fail(f"secure LM {what}: the card's logits or KV cache "
                     f"differ from the CPU run")
        if not torch.isfinite(out["cuda"][0]).all():
            fail(f"secure LM {what}: logits are not finite")
        print(f"[chip_smoke] secure LM {what} at {c['blocks']} blocks, "
              f"prompt {c['prompt_len']}, gen {c['gen']}: card == CPU bit "
              f"for bit (logits and KV cache; card {out['cuda'][3]:.2f} s, "
              f"CPU {out['cpu'][3]:.2f} s)")
    cache = st.init_kv_cache(c["blocks"], SLM["heads"], hd, 16, RING32,
                             device="cuda")
    _, cache = st.secure_prefill(card, cache, prompt, keys)
    pos = c["prompt_len"]
    step = lambda kc: st.secure_decode_step(card, kc, 1, pos, keys)
    spare = lambda: st.SecureKVCache(cache.k.clone(), cache.v.clone())
    kc = spare()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(kc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kc = spare()
    pr = profile_once(lambda: step(kc), torch.device("cuda"), wall)
    print(f"[chip_smoke] secure LM decode step at {c['blocks']} blocks "
          f"(customized + RMSNorm), profiled: device busy "
          f"{pr['device_us']:.0f} us of a {wall * 1e6:.0f} us step "
          f"({100 * pr['busy_share']:.1f}%), {pr['device_kernels']} device "
          f"kernels; " + ", ".join(f"{r['name'][:40]} {r['device_us']:.0f} us"
                                   for r in pr["top"][:4]))
    del card
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 12. the mesh: one party a process
# ---------------------------------------------------------------------------

def check_pair_kernels(paths: dict) -> list:
    """Phase 12 (kernels): B1's and B2's pair entries (one party, S = 1,
    the neighbour share from its own pointer) at every per-party shape
    phase 12's paths give them (CifarNet2 and MnistNet1 with shared
    weights: the stacked shapes with S = 1; the secure LM's decode shapes
    at MESH_LM's depth) == their plain versions, exactly (B1 on both
    routes, split shapes repeated bit for bit); timed beside the stacked
    entry on the same S = 1 inputs.  Returns the two rows; ``ms`` and the
    bounds sum one rank's launches of one query of each classifier path
    and of one LM token."""
    import torch
    from repro_torch.kernels import bin_rss_matmul as grp
    from repro_torch.kernels import limbs
    from repro_torch.kernels import rss_matmul as dense
    from repro_torch.kernels.lowering import KernelConfig

    sms = limbs.sm_count(torch.device("cuda"))
    g = torch.Generator().manual_seed(12)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=g)

    dense_shapes, grouped_shapes = {}, {}
    for key in MESH_PATHS:
        for (xs, n), cnt in paths[key]["rss_matmul"].items():
            k1 = ((1,) + xs[1:], n)
            dense_shapes[k1] = dense_shapes.get(k1, 0) + cnt
        for (xs, n, c_contig), cnt in paths[key]["grouped_rss_matmul"] \
                .items():
            k1 = ((1,) + xs[1:], n, c_contig)
            grouped_shapes[k1] = grouped_shapes.get(k1, 0) + cnt
    for (k, n), per_tok in B1_DECODE.items():   # at MESH_LM's depth
        blocks_tok = per_tok // SLM_BLOCKS * MESH_LM["blocks"] if n != \
            SLM["vocab"] else 1
        k1 = ((1, 1, k), n)
        dense_shapes[k1] = dense_shapes.get(k1, 0) + blocks_tok
    rows = []
    for name, shapes in (("rss_matmul_pair", dense_shapes),
                         ("grouped_rss_matmul_pair", grouped_shapes)):
        tot = {"ms": 0.0, "stacked_ms": 0.0, "plain_ms": 0.0, "b": 0.0,
               "o": 0.0}
        detail = []
        for key, per in sorted(shapes.items()):
            plan = None
            if name == "rss_matmul_pair":
                (s, m, k), n = key
                x, xn = words(s, m, k), words(s, m, k)
                wl = dense.pair_weight_limbs(words(2, k, n))
                xd, xnd, wd = x.cuda(), xn.cuda(), on_card(wl)
                run = lambda: dense.rss_matmul_parts(xd, wd, x_next_stack=xnd)
                stacked = lambda: dense.rss_matmul_parts(xd, wd)
                plain = lambda: dense.rss_matmul_parts_ref(x, wl, xn)
                plan = limbs.limb_mma_plan(s, m, k, n, sms)
                other = lambda r: dense._launch(xd, wd, KernelConfig(r), xnd)
                nbytes = 4 * (2 * m * k + 2 * k * n + m * n)
                ops = 40 * m * k * n
                desc = {"S": s, "M": m, "K": k, "N": n}
            else:
                (s, c, m, k), n, c_contig = key
                x, xd = _grouped_x(words, s, c, m, k, c_contig)
                xn, xnd = _grouped_x(words, s, c, m, k, c_contig)
                full = grp.grouped_weight_limbs(words(3, c, k, n))
                wl = grp.GroupedWeightLimbs(*(a[0:1] for a in full))
                wd = on_card(wl)
                run = lambda: grp.grouped_rss_matmul_parts(
                    xd, wd, x_next_stack=xnd)
                stacked = lambda: grp.grouped_rss_matmul_parts(xd, wd)
                plain = lambda: grp.grouped_rss_matmul_ref(x, wl, xn)
                nbytes = 4 * (2 * c * m * k + 2 * c * k * n + c * m * n)
                ops = 40 * c * m * k * n
                desc = {"S": s, "C": c, "M": m, "K": k, "N": n}
            got = run()
            torch.cuda.synchronize()
            want = plain()
            err = int((got.cpu().long() - want.long()).abs().max())
            if err != 0:
                fail(f"{name} {desc}: kernel != plain version (max abs err "
                     f"{err})")
            route = ""
            if plan is not None:
                desc.update(route=plan[0], splits=plan[2])
                route = f", {plan[0]}, split-K {plan[2]}"
                if plan[2] > 1:
                    for _ in range(SPLIT_REPEATS):
                        if not torch.equal(run(), got):
                            fail(f"{name} {desc}: repeats differ")
                alt = (limbs.CUDA_CORE if plan[0] == limbs.TENSOR_CORE
                       else limbs.TENSOR_CORE)
                if not torch.equal(other(alt), got):
                    fail(f"{name} {desc}: the {alt} route != plain version")
            ms, st_ms = median_ms(run), median_ms(stacked)
            pms = host_ms(plain)
            b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({**desc, "per_rank_query": per, "ms": ms,
                           "stacked_s1_ms": st_ms, "plain_ms": pms,
                           "bound_ms": bound})
            print(f"[chip_smoke] {name} {desc} x{per}/rank: {ms:.5f} ms, the "
                  f"stacked entry at S = 1 {st_ms:.5f} ms (bound "
                  f"{bound:.5f} ms, {100 * bound / ms:.1f}%), plain on host "
                  f"{pms:.3f} ms, exact{route}")
            tot["ms"] += per * ms
            tot["stacked_ms"] += per * st_ms
            tot["plain_ms"] += per * pms
            tot["b"] += per * b_ms
            tot["o"] += per * o_ms
        print(f"[chip_smoke] {name} over one rank's query of each mesh path "
              f"and an LM token: {tot['ms']:.5f} ms, the stacked entry "
              f"{tot['stacked_ms']:.5f} ms, bound "
              f"{max(tot['b'], tot['o']):.5f} ms")
        row = _row(name, tot["ms"], tot["plain_ms"], tot["b"], tot["o"],
                   None, 0, detail)
        row["stacked_ms"] = tot["stacked_ms"]
        rows.append(row)
    return rows


def mesh_phase() -> dict:
    """Phase 12 (paths): three gloo ranks on the card serve CifarNet2
    (shared and public weights, inline), MnistNet1 (tape pool; verify
    full and the carried-pair fault cells) and the secure LM, each held to
    the local backend on the card; prints q/s of both backends in turns,
    every rank's wire beside the ledger, staging and busy share.  Each
    rank's launches, as it counted them, are held exactly to one a linear
    layer a query (one a projection a step on the LM) on the path's
    kernels.  Returns the ranks' launches, summed."""
    import numpy as np
    import torch
    from repro_torch.core import integrity, prf, transport
    from repro_torch.core.party_group import PartyGroup
    from repro_torch.core.preprocessing import generate_tape, trace_material
    from repro_torch.core.randomness import Parties
    from repro_torch.core.ring import RING32
    from repro_torch.core.rss import share
    from repro_torch.core.secure_model import (make_secure_infer_mesh,
                                               secure_infer)
    from repro_torch.launch.serve_secure import build, serve, serve_lm
    from repro_torch.nn.bnn import ALL_NETS, INPUT_SHAPES
    import functools

    launches: dict = {}

    def one_query(net, dense, grouped):
        """A rank's launches in one query of ``net``: ``dense`` once a
        linear layer, ``grouped`` once a sepconv's depthwise half."""
        spec = ALL_NETS[net]
        want = {dense: sum(l.kind in ("conv", "fc", "sepconv")
                           for l in spec),
                grouped: sum(l.kind == "sepconv" for l in spec)}
        return {k: v for k, v in want.items() if v}

    def take(what, rank_counts, per_run, runs):
        """Hold each rank's launches to ``runs`` × ``per_run`` exactly and
        add them to the phase's."""
        for r, got in enumerate(rank_counts):
            got = {k: c for k, c in got.items() if c}
            want = {k: runs * c for k, c in per_run.items()}
            if got != want:
                fail(f"{what}: rank {r} launched {got}, want {want}")
            for k, c in got.items():
                launches[k] = launches.get(k, 0) + c

    with PartyGroup("cuda", timeout=120, deadline=600) as g:
        # -- CifarNet2 shared and public, inline: local and mesh in turns --
        for weights, kernels in (("shared", ("rss_matmul_pair",
                                             "grouped_rss_matmul_pair")),
                                 ("public", ("bin_rss_matmul",
                                             "bin_grouped_matmul"))):
            what = f"CifarNet2 {weights} batch {BATCH}"
            qps = {"local": [], "mesh": []}
            runs = {}
            for backend in ("local", "mesh", "mesh", "local"):
                st = serve("CifarNet2", BATCH, MESH_QUERIES, device="cuda",
                           weights=weights, backend=backend, group=g,
                           profile=backend == "mesh" and "mesh" in runs)
                qps[backend].append(round(st["query_per_s"], 4))
                runs.setdefault(backend, st)
                if backend == "mesh":
                    take(what, st["rank_launches"],
                         one_query("CifarNet2", *kernels), st["mesh_runs"])
                    runs["mesh_last"] = st
            loc, msh = runs["local"], runs["mesh_last"]
            if not np.array_equal(msh["logits"], loc["logits"]):
                fail(f"{what}: mesh logits != local logits on the card")
            if not msh["wire_rel_diff"] < 0.02:
                fail(f"{what}: wire {msh['wire_bytes']} vs ledger "
                     f"{msh['ledger_bytes']}")
            busy = msh["rank_busy_share"]
            per_q = {k: v for k, v in msh["launches_per_query"].items() if v}
            staging = [round(v, 4) for v in msh["rank_staging_ms_per_query"]]
            secs = [round(v, 5) for v in msh["rank_seconds"]]
            print(f"[chip_smoke] mesh {what}: logits == local bit for bit; "
                  f"q/s in turns (local, mesh, mesh, local) local "
                  f"{qps['local']} mesh {qps['mesh']}; wire "
                  f"{msh['wire_bytes']:,} B over the ranks "
                  f"{msh['rank_wire_bytes']} ({msh['rank_wire_messages']} "
                  f"messages) vs ledger {msh['ledger_bytes']:,} B online + "
                  f"offline (rel diff {msh['wire_rel_diff']:.2e}); staging "
                  f"ms a query {staging}; rank seconds {secs} (dealer's "
                  f"wall {msh['wall_seconds']:.4f} s); device busy share a "
                  f"rank {[round(b, 4) for b in busy] if busy else None}; "
                  f"launches a query {per_q}")

        # -- MnistNet1: tape pool, verify full, the fault cells -----------
        inline = serve("MnistNet1", BATCH, MESH_QUERIES, device="cuda")
        local_pool = serve("MnistNet1", BATCH, MESH_QUERIES, device="cuda",
                           offline="pool", pool_depth=4)
        pool = serve("MnistNet1", BATCH, MESH_QUERIES, device="cuda",
                     backend="mesh", group=g, offline="pool", pool_depth=4)
        mnist = one_query("MnistNet1", "rss_matmul_pair", None)
        take("MnistNet1 mesh pool", pool["rank_launches"], mnist,
             pool["mesh_runs"])
        if pool["rank_prf_calls_per_query"] != [0, 0, 0]:
            fail(f"MnistNet1 mesh pool: threefry calls a query "
                 f"{pool['rank_prf_calls_per_query']}")
        if not pool["wire_bytes"] == pool["wire_online_bytes"] \
                == pool["online_bytes"]:
            fail(f"MnistNet1 mesh pool: wire {pool['wire_bytes']} (online "
                 f"{pool['wire_online_bytes']}) != online ledger "
                 f"{pool['online_bytes']}")
        if not np.array_equal(pool["logits"], local_pool["logits"]):
            fail("MnistNet1 mesh pool: logits != the local pool's")
        # a tape slice at the inline run's keys: tape-backed mesh == inline
        model = build("MnistNet1", device="cuda")
        x = np.random.default_rng(0).integers(
            0, 2, (BATCH,) + INPUT_SHAPES["MnistNet1"]).astype(np.float32) \
            - 0.5
        xs = share(torch.as_tensor(x, device="cuda"), prf.PRNGKey(3), RING32)
        keys = Parties.setup(prf.PRNGKey(7)).keys
        spec = trace_material(model, tuple(x.shape))
        fn = make_secure_infer_mesh(model, g, tape_spec=spec)
        try:
            tape_out = fn(keys, xs.shares, generate_tape(
                spec, [keys], device="cuda").query_slice(0))
        finally:
            fn.close()
        take("MnistNet1 mesh tape", [rk["launches"] for rk in
                                     fn.last["ranks"]], mnist, 1)
        if not torch.equal(tape_out.cuda(), secure_infer(
                model, xs, Parties(keys, device="cuda"))):
            fail("MnistNet1 mesh tape != inline local at the same keys")
        print(f"[chip_smoke] mesh MnistNet1 batch {BATCH} pool (depth 4): 0 "
              f"threefry calls a query in every rank; online wire "
              f"{pool['wire_bytes']:,} B == online ledger "
              f"{pool['online_bytes']:,} B; logits == the local pool's, and "
              f"a tape slice at the inline keys == inline local; online "
              f"{pool['query_per_s_online']:.3f} q/s, amortised "
              f"{pool['query_per_s']:.3f} q/s (local: online "
              f"{local_pool['query_per_s_online']:.3f}, amortised "
              f"{local_pool['query_per_s']:.3f}, inline "
              f"{inline['query_per_s']:.3f} q/s)")
        ver = serve("MnistNet1", BATCH, MESH_QUERIES, device="cuda",
                    backend="mesh", group=g, verify="full")
        take("MnistNet1 mesh verify", ver["rank_launches"], mnist,
             ver["mesh_runs"])
        if not np.array_equal(ver["logits"], inline["logits"]):
            fail("MnistNet1 mesh verify full: logits != unverified")
        cells = []
        for op, party in FAULT_OPS:
            f = integrity.Fault(op, 0, "corrupt", party)
            ft = integrity.FaultInjectingTransport(transport.LocalTransport(),
                                                   [f])
            v = integrity.Verifier("full")
            with transport.use_transport(ft), integrity.verify_scope(v):
                secure_infer(model, xs, Parties(keys, device="cuda"))
                rep = v.traced_report()
            try:
                v.check(rep)
                fail(f"fault {op}: not caught on the local backend")
            except integrity.IntegrityError as e:
                want = (e.op, e.index, e.tag, e.round, e.party)
            fn = make_secure_infer_mesh(
                model, g, verifier=integrity.Verifier("full"),
                transport_wrap=functools.partial(
                    integrity.FaultInjectingTransport, faults=[f]))
            try:
                fn(keys, xs.shares)
                fail(f"fault {op}: not caught on the mesh")
            except integrity.IntegrityError as e:
                got = (e.op, e.index, e.tag, e.round, e.party)
            finally:
                fn.close()
            take(f"fault {op}", [rk["launches"] for rk in
                                 fn.last["ranks"]], mnist, 1)
            if got != want:
                fail(f"fault {op}: mesh {got} vs local {want}")
            cells.append(f"{op}->{got}")
        print(f"[chip_smoke] mesh MnistNet1 verify full: logits == "
              f"unverified ({ver['verified_ops']} ops a query, "
              f"{ver['query_per_s']:.3f} q/s); carried-pair fault cells "
              f"== local fields: " + "; ".join(cells))

        # -- the secure LM at TinyLlama's widths, MESH_LM's depth ----------
        torch.cuda.empty_cache()
        lm_kw = dict(**SLM, **MESH_LM, device="cuda")
        loc = serve_lm(**lm_kw)
        loc_cache = (loc["cache"].k.cpu(), loc["cache"].v.cpu())
        del loc["cache"]
        torch.cuda.empty_cache()
        msh = serve_lm(**lm_kw, backend="mesh", group=g)
        steps = (MESH_LM["queries"] + 1) * (MESH_LM["prompt_len"]
                                            + MESH_LM["gen"] - 1)
        take("secure LM mesh", msh["rank_launches"],
             {"rss_matmul_pair": 6 * MESH_LM["blocks"] + 1,
              "ring_matmul_batched": 2 * MESH_LM["blocks"]}, steps)
        if msh["tokens"] != loc["tokens"] \
                or not np.array_equal(msh["logits"], loc["logits"]):
            fail("secure LM mesh: logits or tokens != local on the card")
        k, v = msh["cache"]
        for got, want in ((k, loc_cache[0]), (v, loc_cache[1])):
            if not (torch.equal(got[0::2], want) and torch.equal(
                    got[1::2], torch.roll(want, -1, dims=0))):
                fail("secure LM mesh: a rank's KV cache pair != its rows "
                     "of the local cache")
        print(f"[chip_smoke] mesh secure LM d {SLM['d']} {MESH_LM['blocks']}"
              f" blocks, prompt {MESH_LM['prompt_len']}, gen "
              f"{MESH_LM['gen']}: logits, tokens and every rank's KV cache "
              f"== local bit for bit; tok/s local {loc['tok_per_s']:.4f} "
              f"mesh {msh['tok_per_s']:.4f} (decode local "
              f"{loc['decode_tok_per_s']:.4f} mesh "
              f"{msh['decode_tok_per_s']:.4f}); wire a decode step "
              f"{msh['wire_bytes_per_step']:,} B == ledger "
              f"{msh['ledger_bytes_per_step']:,} B; staging ms a step "
              f"{[round(v, 3) for v in msh['rank_staging_ms_per_step']]}; "
              f"launches a token (all ranks) {msh['launches_per_token']}")
    return launches


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
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {name} {fn}: {line.strip()}")
    smi = smi_line()
    print(f"[chip_smoke] card: {smi}")
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda}"
          f" on {torch.cuda.get_device_name(0)}")

    # -- 2. kernels vs plain versions at the paths' shapes -----------------
    # the least a launch reads between the events: a 4-byte zero_
    word = torch.zeros(1, dtype=torch.int32, device="cuda")
    print(f"[chip_smoke] launch floor (a 4-byte zero_ between two events): "
          f"{median_ms(word.zero_):.5f} ms")
    # per-query counts: one query of each path of PINNED
    t0 = time.perf_counter()
    paths, requests = {}, {}
    for key in PINNED:
        paths[key], requests[key] = path_shapes(*key)
    shapes = {name: {} for name in LINEAR_KERNELS}
    for seen in paths.values():
        for name, d in seen.items():
            for key, cnt in d.items():
                shapes[name][key] = shapes[name].get(key, 0) + cnt
    rows = check_kernels(shapes) + check_ring_kernels()
    print(f"[chip_smoke] kernels phase {time.perf_counter() - t0:.1f} s")

    # -- 3. the serving paths ---------------------------------------------
    import numpy as np
    from repro_torch.core import linear
    from repro_torch.launch.serve_secure import serve
    from repro_torch.nn.bnn import INPUT_SHAPES, bnn_forward, init_bnn
    t0 = time.perf_counter()
    relu_in = {}
    for net in RELU_NETS:
        # He-normal weights: ReLU is continuous, so no grid is needed
        params = init_bnn(0, net, device="cuda")
        x = np.random.default_rng(1).normal(0, 0.3, (BATCH,)
                                            + INPUT_SHAPES[net]) \
            .astype(np.float32)
        plain, _ = bnn_forward(params, torch.as_tensor(x, device="cuda"),
                               net, binarize=False)
        relu_in[net] = (params, x, plain.cpu().numpy())
    launches = {name: 0 for name in kbuild.LAUNCHES}
    for key, pinned in PINNED.items():
        net, weights, binary_linear, fused = key
        queries = QUERIES if binary_linear == "auto" else 1
        given = ({"params": relu_in[net][0], "x": relu_in[net][1]}
                 if net in RELU_NETS else {})
        linear.set_fused_rounds(fused)
        try:
            kbuild.reset_launches()
            st = serve(net, BATCH, queries, device="cuda", weights=weights,
                       binary_linear=binary_linear, **given)
            counts = dict(kbuild.LAUNCHES)
        finally:
            linear.set_fused_rounds(True)
        got = (st["online_rounds"], st["online_bytes"], st["offline_rounds"],
               st["offline_bytes"])
        what = f"{net} {weights}/{binary_linear} fused={fused}"
        print(f"[chip_smoke] {what} batch {BATCH} on {st['kind']}: {queries} "
              f"queries in {st['seconds']:.4f} s = {st['query_per_s']:.3f} "
              f"q/s ({st['img_per_s']:.1f} img/s), compile "
              f"{st['compile_s']:.3f} s; ledger {got}; launches "
              f"{launched(kbuild)}")
        if got != pinned:
            fail(f"{what}: ledger {got} != pinned {pinned}")
        want = sorted(name for name, d in paths[key].items() if d)
        ran = sorted(name for name, c in counts.items() if c)
        if ran != want:
            fail(f"{what}: launched {ran}, its path calls {want}")
        lg = st["logits"]
        if lg.shape != (BATCH, 10) or not (np.abs(lg) < 1e6).all():
            fail(f"{what}: logits of shape {lg.shape} are not finite")
        if net in RELU_NETS:
            err = float(np.abs(lg - relu_in[net][2]).max())
            print(f"[chip_smoke] {what}: secure vs plaintext max |err| "
                  f"{err:.6f}")
            if not err < 0.25:
                fail(f"{what}: secure logits differ from the plaintext "
                     f"forward by {err}")
        for name in launches:
            launches[name] += counts[name]
    by_phase = {"path": launches}
    print(f"[chip_smoke] path phase {time.perf_counter() - t0:.1f} s")

    # -- 4. values ----------------------------------------------------------
    from repro_torch.weights import grid_quantize
    t0 = time.perf_counter()
    for net in ("MnistNet1", "MnistNet3-sep"):
        params = grid_quantize(init_bnn(0, net, device="cuda"))
        rng = np.random.default_rng(1)
        x = rng.integers(0, 2, (BATCH,) + INPUT_SHAPES[net]) \
            .astype(np.float32) - 0.5
        plain, _ = bnn_forward(params, torch.as_tensor(x, device="cuda"), net)
        for weights in WEIGHT_MODES:
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
    for net in ("CifarNet2", "CifarNet7"):
        for weights in WEIGHT_MODES:
            on_card = serve(net, 2, 1, device="cuda", x=x,
                            weights=weights)["logits"]
            on_host = serve(net, 2, 1, device="cpu", x=x,
                            weights=weights)["logits"]
            if not np.array_equal(on_card, on_host):
                fail(f"{net} {weights}: logits on the card differ from the "
                     f"CPU run")
            print(f"[chip_smoke] {net} {weights} batch 2: card == CPU, bit "
                  f"for bit")
    print(f"[chip_smoke] values phase {time.perf_counter() - t0:.1f} s")

    # -- 5. the autotuner, the path solver, telemetry ---------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        by_phase["tuned"] = tuned_phase(kbuild, requests, Path(tmp))
    print(f"[chip_smoke] tuned phase {time.perf_counter() - t0:.1f} s")

    # -- 6. the tape pool and the verified runtime ---------------------------
    t0 = time.perf_counter()
    by_phase["offline-verify"] = offline_verify_phase(kbuild)
    print(f"[chip_smoke] offline + verify phase "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 7.-8. the per-dot route, the binarized products ---------------------
    t0 = time.perf_counter()
    by_phase["per-dot"] = per_dot_phase(kbuild)
    by_phase["binary"] = binary_phase(kbuild)
    print(f"[chip_smoke] per-dot + binary phases {time.perf_counter() - t0:.1f}"
          f" s")

    # -- 9.-10. the LM kernels and paths -----------------------------------
    from repro_torch.configs import get_config
    from repro_torch.nn.transformer import init_params
    t0 = time.perf_counter()
    mamba_cfg = get_config("mamba2-1.3b")
    mamba = init_params(mamba_cfg, 0, "cuda")
    rows.append(check_flash())
    rows.append(check_ssd(mamba_layer_inputs(mamba_cfg, mamba,
                                             lm_tokens(mamba_cfg.vocab))))
    print(f"[chip_smoke] lm kernels phase {time.perf_counter() - t0:.1f} s")
    # one model on the card at a time, so each serve's peak memory is its own
    t0 = time.perf_counter()
    by_phase["mamba2-prefill"] = mamba_phase(kbuild, mamba, mamba_cfg)
    del mamba
    torch.cuda.empty_cache()
    llama_cfg = get_config("tinyllama-1.1b")
    by_phase["tinyllama-prefill"] = tinyllama_phase(
        kbuild, init_params(llama_cfg, 0, "cuda"), llama_cfg)
    print(f"[chip_smoke] lm paths phase {time.perf_counter() - t0:.1f} s")

    # -- 11. the secure LM ---------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rows.append(check_secure_lm_kernels(rows))
    by_phase["secure-lm"] = secure_lm_phase(kbuild)
    secure_lm_card_vs_cpu()
    print(f"[chip_smoke] secure LM phase {time.perf_counter() - t0:.1f} s")

    # -- 12. the mesh: one party a process -----------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    rows += check_pair_kernels(paths)
    by_phase["mesh"] = mesh_phase()
    print(f"[chip_smoke] mesh phase {time.perf_counter() - t0:.1f} s")
    for row in rows:
        row["launches_by_phase"] = {ph: c.get(row["name"], 0)
                                    for ph, c in by_phase.items()}
        row["launches"] = sum(row["launches_by_phase"].values())
        if row["launches"] <= 0:
            fail(f"{row['name']} was launched on no path")
    print(f"[chip_smoke] total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
