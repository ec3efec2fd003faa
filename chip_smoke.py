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
              slot read twice) at every shape, and B4 its first design
              (one slot a grid row, every block staging the whole slab
              before its first x load).  Then the ring kernels (B5
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
              serve(offline="pool", pool_depth=4) for 4 queries (and one
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
              prefill shape (2, 2048, 32, 4, 64) (the row's numbers); the
              wide heads: hd 96 and 128 in float32 and at a ragged S = 1000
              with GQA in bf16, and the 2 x 2048 prefill shapes of
              phi3-mini-3.8b (32 heads of 96), minitron-4b (24 / 8 of
              128), jamba-v0.1-52b (32 / 8 of 128) and deepseek-67b (64 /
              8 of 128), and minitron-4b's tensor-parallel rank shapes at
              m = 16 (2 / 1 and 1 / 1 of 128: 24 heads over 16 ranks, 1
              or 2 a rank), each timed beside SDPA; B9 ssd_scan at the
              reference's three kernel-test shapes and at Mamba2-1.3B's
              layer shape (1 and 2, 2048, 64, 64, 128; chunk 256) on the
              inputs of a full-width Mamba2 layer, all within 2e-5 of max
              |y| of the plain version's float64 evaluation (the float32
              one's own gap printed) and bit-identical on repeats, each
              beside the serial
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
              FFN, no RoPE), 2 of TinyLlama's 22 blocks (a weight element
              holds 84 B on the card; the script's time limit).  First the batched B5 on its own at
              the decode step's products (96 = 3 parties x 32 heads of
              (1, 128) x (128, bucket) and (1, 2 bucket) x (2 bucket, 64) at
              buckets 16 and 64: _bmm doubles K) == its plain version on CPU
              copies, bit for bit and on repeats, both routes and the split
              pass too, timed beside the 2-D entry looped over the batch;
              and B1 at its decode shapes (M = 1: 2048 x 2048, 2048 x 5632,
              5632 x 2048, 2048 x 32000) == its plain version, timed, with
              the sum a token.  Then serve_lm (customized attention, full
              RMSNorm; prompt 4, gen 4, buckets 16,64, a warm-up and 1 timed
              generation) with the counts zeroed before
              and read after: it must launch only B1 and the batched B5, at
              their exact counts, and its ledger equals lm_step_cost (or it
              raises); prints prefill seconds, decode tok/s, KB and rounds a
              token, peak memory, launches a token, threefry calls a step,
              and the logits' largest gap to plaintext_lm_forward relative
              to its scale and the top-1 agreement (reported, not gated).
              Last, at 2 blocks, a prompt of 2 and 2 tokens under customized
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
              same S = 1 inputs, B2's also beside its first design; and
              B4 at the shapes a rank of the public path gives it (its
              pair of slots, S = 2) == its plain version, timed beside its
              first design.  Then serve(backend="mesh"): CifarNet2
              with shared weights (B1 and B2 on their pair entries) and
              public ones (B3 and B4 at S = 2) at batch 32, local and mesh
              in turns (local, mesh, mesh, local; 2 queries a run, the
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
              LM at SLM's widths and 1 block (prompt 2, gen 2, bucket 16)
              on both backends: logits, tokens and every rank's pair of
              the KV cache == local bit for bit, tok/s of both, the wire a
              decode step == its ledger.
13. distill - distill.run_pipeline at the reference's defaults (both
              families, 6,000 / 1,000 synthetic images, 2 epochs, batch
              128, λ 0.1, T 10, all three modes, secure accuracy in every
              mode on the first 64 test images): teachers and students
              trained on the card with torch's deterministic algorithms
              (without them two runs trained students up to 2.07 apart in a
              weight, so the rows would change run to run), every student
              compiled and served securely on its trained weights (B1 and
              B2 shared, B3 and B4 public).  Each secure evaluation's
              logits on its first batch of 16 must equal the CPU run of
              the port on the same weights and keys (the reference
              protocol's) bit for bit.  Each secure evaluation runs with
              the counts zeroed
              before and read after and must launch exactly its path's
              meta-run kernels, per batch of 16, and records the shape
              each of B1-B4 is given; every recorded shape phase 2 lacks
              (all of them: phase 2 runs batch 32) is held exactly to its
              plain version as in phase 2, untimed.  Its secure accuracy
              must equal the plaintext evaluate on the same images (on
              synthetic data both read about 1.000 in every row, so this
              gate alone would pass a wrong kernel that flips no argmax;
              the fixed-point protocol's logits sit a few units from the
              plaintext ones, so it holds only while no image's top-2
              margin is that small, and a failure prints each
              disagreeing image's margin and gap); each
              student's accuracy may sit at most 0.05 below its
              BENCH_pareto.json row, and params, online KB, rounds and
              post-Sign KB (the BN folds change no message) must equal it.
              Prints the 18 rows beside the reference's and the seconds of
              training, compiling and the secure queries.
14. train-lm - make_train_step at TinyLlama-1.1B's full widths and depth
              (22 blocks) on token_stream batches of 4 x 256, 8 steps at
              warm-up 3: the mean loss of the last 3 steps must sit below
              that of the first 3; prints each step, the median step time,
              tok/s and peak memory, and profiles one more step.  Then
              the reduced trainer with checkpoints in a temporary
              directory, crashed at step 4 and resumed, against an
              uninterrupted run (the reference test's rtol/atol 2e-4,
              loss 2e-3).
15. zoo     - phi3-mini-3.8b and minitron-4b at full width and depth (32
              layers each) and jamba-v0.1-52b at full width and one period,
              8 of its 32 layers (a period is 49.4 GiB in float32; four
              would not fit the card), one model on the card at a time:
              the prefill step at 2 x 2048 on the _sdpa route and through
              flash_impl (B8 exactly 32, 32 and 1 times, nothing else); the
              dense two's last-position logits within 3% of their scale
              of each other, jamba's gap printed, not gated (a bf16 ulp
              flips a top-2 expert choice), with the routing decisions
              (expert id or kept slot) that differ between the routes at
              each MoE layer.  Then jamba sub-layer by sub-layer as in
              phase 10, each sub-layer given the same input on both routes
              and the plain result carried on: the attention sub-layer on
              B8 against _sdpa (within 3%), each Mamba sub-layer's scan on
              B9 against ssd_prefill (within 2^-6), launches exactly B8 1
              and B9 7; B9 alone at jamba's layer shape (2, 2048, 128, 64,
              N 16) against its plain version, as in phase 9.  Then serve
              (batch 4, prompt 16, gen 16) of each: tok/s, peak memory,
              tokens in range, logits finite; jamba's decode capacity is 1
              slot an expert (the reference's rule), its drop share
              printed, and one more decode step profiled.
16. zoo-2   - the rest of the reference's architectures, one model on the
              card at a time, seed-0 weights drawn there, each printed with
              its device memory at the start, its peak, its parameters and
              the full model's: deepseek-v2-236b at full width and 4 of its
              60 layers (1 dense + 3 MoE of 160 experts, top-6, 2 shared;
              13.30 G parameters, 49.6 GiB in float32) and deepseek-v3-671b
              at 4 of 61 (its 3 dense + 1 MoE of 256 experts, top-8, 1
              shared, and the MTP head; 15.21 G, 56.7 GiB): the prefill
              step at 2 x 2048 on both routes (MLA never takes the flash
              hook: no launch, the same routing, logits within 3%), each
              MoE layer's capacity and dropped-choice share, serve (batch
              4, prompt 16, gen 16; absorbed MLA decode), one more
              generation with naive MLA decode fed the same tokens and
              expert choices (every step's logits within 5% of their
              scale, the reference's test_mla bound; the largest gap, the
              choices its own router would change and the first step whose
              argmax parts printed); v3's decode step profiled and its
              loss_fn with the MTP term at 1 x 512 (finite, beside
              ln(vocab)).  Then pixtral-12b at full depth (40 layers, 45.6
              GiB): the prefill step over 2 x (1,024 N(0, 1) bf16 patch
              slots + 1,024 tokens) on both routes, B8 exactly 40 times on
              the flash route and never on _sdpa, logits within 3%; serve
              from text tokens.  hubert-xlarge at full depth (48 layers):
              the forward over 2 x 2048 N(0, 1) bf16 frames on both routes,
              no B8 launch (non-causal: _sdpa), finite logits, tok/s; serve
              must raise ValueError (encoder-only).
17. launch  - the last modules: (1) the roofline terms
              (repro_torch.roofline.analyze, the H100's peaks) of every LM
              step phases 10 and 14-16 timed (prefill on both routes, each
              served decode step, the train step), with the measured
              model-FLOPs share model_flops / seconds / 989e12: a share
              above 1.05 fails (the count would be wrong); no new run.
              (2) The party x data batch axis: CifarNet2 shared and
              MnistNet1 at batch 32 on 3 x 2 gloo ranks on the card (each
              data shard a triple of ranks, B1's and B2's pair entries on
              every rank, each rank's launches exactly one a linear layer a
              query); logits == the CPU port's batch-axis run bit for bit,
              every rank's wire beside the ledger (a shard's x 2), q/s
              beside phase 12's party-only mesh.  (3) TinyLlama-1.1B's
              train step at full width on a (1, 1) DeviceMesh (parameters
              and moments DTensors), 4 x 256, 4 steps, held to the
              mesh-less step at rtol / atol 2e-4 and loss 2e-3, its step
              time and peak memory beside phase 14's.  (4) One MoE layer
              at jamba's widths (16 experts, d 4096, d_ff 14336, top-2,
              capacity factor 8) on the (1, 1) mesh with "shardmap" held
              to "dense" within 0.15 of max |y|.  (5) Two ranks on the
              card in one gloo group, where the (1, 1) mesh moves nothing:
              the "shardmap" MoE (16 experts, d 1024, d_ff 2048, top-2,
              capacity factor 8, 2 x 512 tokens) on a (1, 2) mesh against
              "dense" within 0.15 of max |y|, each rank's experts'
              gradient / 2 within 2^-6 of dense's; int8_psum of CUDA
              tensors within one int8 step of the host's dequantized
              sum and within 2 max|g| / 127 of the exact sum; TinyLlama-1.1B at
              full width and 8 of 22 layers, 3 sharded train steps on a
              (2, 1) mesh (each rank half the batch; each layer's storage
              shards gathered over "data" for that layer alone, again in
              its recomputation, exactly 2 x 7 a layer + the embedding's
              and the head's a step; gradients reduce-scattered back)
              against the mesh-less steps: loss 2e-3, gradient norm 1e-2
              relative, parameters 2e-4 + 2·lr a step; rank 0's peak
              beside the mesh-less step's, the seconds in collectives a
              step.  (6) Two ranks on
              the card, TinyLlama-1.1B at full width and depth
              tensor-parallel on a (1, 2) mesh: prefill 2 x 2048 with B8
              on each rank's 16 heads (exactly 22 launches a rank, logits
              within 3% of the mesh-less B8 prefill's scale); each leaf's
              first-step gradient against the mesh-less one (norm 1e-2
              relative, |g - ref| within 0.1 of |ref|); 2 train steps
              (loss 2e-3, gradient norm 1e-2 relative, parameters 2e-4 +
              2·lr a step); each rank's widths half; step times, the
              seconds in collectives and peaks printed.  (7) The secure
              dry run (launch.dryrun_secure) at d 4096, d_ff 14336, 2,048
              tokens: paper3 / opt2 ring products exactly 1.5 (B5 launches
              18 / 12), the fused route on B1, each timed.  (8) The dry
              runs of
              tinyllama-1.1b train_4k, deepseek-v3-671b decode_32k,
              minitron-4b train_4k and phi3-mini-3.8b decode_32k on the
              (16, 16) mesh of 256 fake ranks and TinyLlama's 4 x 256
              train step on the (1, 1) mesh, each a subprocess with a
              timeout, on the host: their memory and roofline records
              printed (deepseek-v3's and minitron's peaks beside those of
              the whole-model gather, the last beside (3)'s measured
              peak), not gated.  (9) In (6)'s group, the layer
              kinds split over "model" since PR 29: (a) TinyLlama-1.1B's
              decode, full width and depth, 8 steps from a seeded 2 x
              4,096 cache, pos on each rank's 2,048 positions in turn
              and on both sides of the boundary, against the mesh-less
              card decode: logits within 3% of scale, layer 0's written
              cache rows within one bf16 ulp, every other layer's finite
              (gap printed), every position no step wrote unchanged; (b)
              Mamba2-1.3B at full width and 12 of 48 layers: the prefill
              2 x 2,048 with each rank's scan on B9 over 32 of 64 heads
              (exactly 12 launches a rank, each held to its plain
              version's float64 evaluation), logits within 3% of the
              mesh-less B9 prefill's; 4 decode steps from a seeded cache;
              (c) deepseek-v2-236b at full width and 2 layers (1 dense,
              1 MoE: 80 of 160 experts a rank), prefill 2 x 512 and 4
              absorbed decode steps from a seeded 2 x 1,024 latent cache
              on the mesh-less run's expert choices
              (``moe.replay_routing``), logits within 3%; the same steps
              on the naive route, split (each rank expands its 512 latent
              positions to every head), on the same choices: within 3% of
              the mesh-less card naive decode and within 5% of the split
              absorbed route (phase 16's bound).  Each part's
              seconds, seconds in collectives and rank peaks printed.

Prints the kernels' JSON line (twelve rows: the nine kernels, B5's batched
entry and B1's and B2's pair entries, each with its launches by phase,
phase 13's secure evaluations and phases 15's and 16's zoo among them;
B8's launches are TinyLlama's 22, phase 15's 66, pixtral-12b's 40 and
phase 17 (6)'s 44; B9's Mamba2's 48, jamba's 7 and phase 17 (9)'s 24),
then the card's name and power limit, then the result line.  Exits
non-zero without a result when no CUDA device is available or when the
port's sources are not beside this script.
"""
from __future__ import annotations

import contextlib
import json
import math
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
# the H100's peaks (HBM_BPS, INT8_OPS, BF16_OPS, FP32_OPS) come from
# repro_torch.peaks, imported by main()
LINEAR_KERNELS = ("rss_matmul", "grouped_rss_matmul", "bin_rss_matmul",
                  "bin_grouped_matmul")
# the grouped kernels' first designs, timed beside them (the row's key)
FIRST_DESIGNS = {"grouped_rss_matmul": "per_party",
                 "bin_grouped_matmul": "per_slot"}
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
# prefill at batch 2 x 2048 (FLASH_ROW: the row's numbers) and a rank's
# share of it on the tensor-parallel (1, 2) mesh of phase 17 (6), 16 q and
# 2 kv heads; then the wide heads: float32 and a ragged S with GQA at hd 96
# and 128, and the 2 x 2048 prefill shapes of phi3-mini-3.8b, minitron-4b,
# jamba-v0.1-52b and deepseek-67b; minitron-4b's tensor-parallel ranks at
# m = 16 (heads [24j/16, 24(j+1)/16): 2 or 1 of its 24, reading one kv
# head), which no two-rank run of the card gives a full-width model; last
# hd 80 on the padded route (hd 96's instantiation on zero-padded heads),
# which no model path launches (the one hd-80 model, hubert-xlarge, is an
# encoder: no causal attention)
FLASH_ROW = (2, 2048, 32, 4, 64, "bfloat16")
FLASH_SHAPES = [(2, 256, 4, 4, 64, "float32"), (2, 256, 8, 2, 64, "float32"),
                (2, 128, 4, 1, 32, "float32"), (2, 1000, 4, 2, 64, "float32"),
                (2, 1000, 8, 2, 64, "bfloat16"),
                (2, 128, 4, 1, 32, "bfloat16"), (2, 256, 4, 4, 64, "bfloat16"),
                FLASH_ROW, (2, 2048, 16, 2, 64, "bfloat16"),
                (2, 256, 4, 2, 96, "float32"), (2, 256, 4, 2, 128, "float32"),
                (2, 1000, 8, 2, 96, "bfloat16"),
                (2, 1000, 8, 2, 128, "bfloat16"),
                (2, 2048, 32, 32, 96, "bfloat16"),
                (2, 2048, 24, 8, 128, "bfloat16"),
                (2, 2048, 32, 8, 128, "bfloat16"),
                (2, 2048, 64, 8, 128, "bfloat16"),
                (2, 2048, 2, 1, 128, "bfloat16"),
                (2, 2048, 1, 1, 128, "bfloat16"),
                (2, 2048, 16, 16, 80, "bfloat16")]
BB_REPEATS = 5             # B7 repeats at MnistNet4's shapes, bit for bit
SPLIT_REPEATS = 5          # B1 / B3 repeats at their split-K shapes
# B9: the reference's kernel-test shapes (B, S, H, hd, N, chunk); Mamba2's
# layer shape comes from a full-width layer
SSD_SHAPES = [(2, 128, 2, 32, 16, 64), (2, 256, 1, 64, 32, 64),
              (2, 64, 4, 16, 8, 32)]
LM_BATCH, LM_SEQ = 2, 2048                  # prefill at full width
SERVE = dict(batch=4, prompt_len=16, gen=16)
LM_TOL, SSD_LAYER_TOL = 0.03, 2.0 ** -6
# B9 vs its plain version, relative to max |y|.  The gate's plain version
# runs the same chunk math in float64 on the host (ssd_chunked's exact
# yardstick), not in float32: on some hosts the float32 plain version
# itself drifts 3.45e-5 of max |y| from the float64 one at the first test
# shape while the kernel sits at 4.33e-7, so a float32 yardstick refused a
# sound kernel there.  A sound kernel read at most 7.7e-6 against the
# float32 plain version (at Mamba2's layer, whose terms cancel to a max
# |y| of 0.07); 2e-5 keeps that margin.
SSD_REL_TOL = 2e-5
SSD_REPEATS = 200          # repeats at each test shape (5 at Mamba2's)
# phase 6: the tape pool's nets, depth and queries; the fault matrix
POOL_NETS = [("MnistNet1", "shared"), ("CifarNet2", "shared"),
             ("CifarNet2", "public")]
# 8 queries until phase 17's per-layer FSDP gathers came (the time limit)
POOL_DEPTH, POOL_QUERIES = 4, 4
FAULT_OPS = (("reshare", 1), ("open", 1), ("send", None))
FAULT_MODES = ("corrupt", "zero", "replay", "drop")
# phase 11: the secure LM at TinyLlama-1.1B's widths inside the reference's
# secure block (MHA, ReLU FFN, no RoPE: share_lm_params' architecture, not
# TinyLlama's), 2 of its 22 blocks: a weight element holds 84 B on the
# card (12 B of shares, 72 B of WeightLimbs), so 12 blocks were ~46 GB;
# cut from 12 to 8 when phase 17's two-rank part came, to 4 when its
# tensor-parallel gradient gate came and to 2 when its per-layer FSDP
# gathers came (the time limit: a step is ~0.5 s a block, host-bound on
# the PRF, and the run serves 30 of them)
SLM = dict(d=2048, heads=32, d_ff=5632, vocab=32000)
SLM_BLOCKS = 2
# one timed generation (two until phase 12 came: the script's time limit)
# (prompt 8, gen 8 and a card == CPU prompt of 4 until phase 17's per-layer
# FSDP gathers came: the time limit)
SLM_SERVE = dict(prompt_len=4, gen=4, buckets=(16, 64), queries=1)
SLM_CHECK = dict(blocks=2, prompt_len=2, gen=2)    # card == CPU
SLM_MODES = ((True, False), (False, False), (True, True))  # custom/softmax
B5_BATCH = 3 * 32          # one product per (party, head)
# B1's decode shapes (K, N) at M = 1 and their launches a token at SLM_BLOCKS
# blocks: wq wk wv wo, up, down, the head
B1_DECODE = {(2048, 2048): 4 * SLM_BLOCKS, (2048, 5632): SLM_BLOCKS,
             (5632, 2048): SLM_BLOCKS, (2048, 32000): 1}
# phase 12: the classifier paths served with one party a process (their
# per-party B1 / B2 shapes are the stacked ones at S = 1), queries a run
# (4 until phase 17's per-layer FSDP gathers came: the time limit), and
# the secure LM at SLM's widths, 1 block, prompt 2, gen 2 (2 blocks,
# prompt 4, gen 4 until then: a mesh step was ~6.5 s)
MESH_PATHS = (("CifarNet2", "shared", "auto", True),
              ("MnistNet1", "shared", "auto", True))
# the mesh's public-weight path: a rank runs B4 on its pair of slots (S = 2)
MESH_PUBLIC = ("CifarNet2", "public", "auto", True)
MESH_QUERIES = 2
MESH_LM = dict(blocks=1, prompt_len=2, gen=2, buckets=(16,), queries=1)
# phase 13: run_pipeline at the reference's defaults (BENCH_pareto.json's
# meta), secure accuracy in every mode on the first 64 test images; its
# secure batch; a student's accuracy may sit this far below the reference's
DISTILL = dict(epochs=2, batch=128, lam=0.1, temperature=10.0, seed=0,
               secure_eval_size=-64)
DISTILL_EVAL_BATCH = 16
DISTILL_ACC_TOL = 0.05
# phase 14: TinyLlama-1.1B's train step at full width and depth; the
# reduced trainer's crash at step 4 of 6 and its resume (the reference
# test's shape and tolerance)
TRAIN_LM = dict(batch=4, seq=256, steps=8, warmup=3)
RESUME = dict(steps=6, global_batch=2, seq_len=16, ckpt_every=2,
              log_every=100)
RESUME_TOL, RESUME_LOSS_TOL = 2e-4, 2e-3
# phase 17: the LM steps phases 10 and 14-16 time, (label, config, shape,
# seconds), and the readings later phases print beside their own
STEP_TIMES: list = []
NOTES: dict = {}
SHARE_GATE = 1.05          # a model-FLOPs share above this is a miscount
BATCH_AXIS_DATA = 2        # data shards of the batch-axis phase: 6 ranks
MESH_TRAIN = dict(batch=4, seq=256, steps=4, warmup=3)
MOE_LAYER = dict(experts=16, d=4096, d_ff=14336, top_k=2, capacity=8.0,
                 batch=2, seq=2048)
MOE_TOL = 0.15             # the reference test's bound, of max |y|
# phase 17 (5): two ranks on the card in one gloo group (CUDA tensors cross
# it through host copies): the MoE at cut widths (every rank holds every
# expert whole, and its gradient), TinyLlama at full width and 8 of 22
# layers on a (2, 1) mesh (each layer's storage gathered over "data" for
# that layer alone, again in its recomputation: a step is 13-19 s of gloo
# host copies)
TWO_RANK_MOE = dict(experts=16, d=1024, d_ff=2048, top_k=2, capacity=8.0,
                    batch=2, seq=512)
TWO_RANK_TRAIN = dict(layers=8, batch=4, seq=256, steps=3, warmup=3)
TWO_RANK_PSUM = (2, 1024, 1024)   # (ranks, rows, cols) of int8_psum's input
GRAD_TOL = 2 ** -6         # bf16 products: of the dense gradient's scale
GNORM_TOL = 1e-2           # a sharded step's gradient norm, relative
# a leaf's first-step gradient, tensor-parallel against mesh-less: its
# norm within GNORM_TOL, and |g - g_ref| / |g_ref| within LEAF_GRAD_TOL (a
# dropped, doubled or misplaced rank's share moves it by 0.5 or more)
LEAF_GRAD_TOL = 0.1
# phase 17 (6): TinyLlama-1.1B at full width and depth, tensor-parallel
# over two ranks on the card ((1, 2) mesh, one gloo group): prefill 2 x
# 2048 on B8 (16 of 32 heads a rank), the train step at 4 x 256
TP_TRAIN = dict(batch=4, seq=256, steps=2, warmup=3)
TP_WIDTHS = {"q_heads": {16}, "kv_heads": {2}, "ffn": {2816},
             "vocab": {16000}}
TP_LOGITS_TOL = 0.03       # phase 15's route gate, of the logits' scale
# phase 17 (9): the decode step and the layer kinds split over "model" on
# the same two ranks: TinyLlama-1.1B's decode from a seeded 2 x 4,096
# cache, pos on each rank's 2,048 positions in turn and on both sides of
# the boundary (inside (6)'s rank task); Mamba2-1.3B at full width and 12
# of 48 layers (prefill 2 x 2,048, each rank's scan on B9 over 32 of 64
# heads; decode from a seeded cache); deepseek-v2-236b at full width and
# 2 layers (1 dense, 1 MoE: 80 of 160 experts a rank), prefill 2 x 512 and
# absorbed decode from a seeded 2 x 1,024 latent cache, on the mesh-less
# run's expert choices
TP_DECODE = dict(batch=2, seq=4096,
                 positions=(5, 2100, 2047, 2048, 1000, 3000, 0, 4095))
TP_MAMBA = dict(layers=12, positions=(2047, 2048, 2049, 2050))
TP_DEEPSEEK = dict(layers=2, batch=2, seq=512, cache=1024,
                   positions=(511, 512, 513, 1023))
SECURE_DRY = dict(tokens=2048, d=4096, d_ff=14336, reps=1)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single"),
                ("deepseek-v3-671b", "decode_32k", "single"),
                ("minitron-4b", "train_4k", "single"),
                ("phi3-mini-3.8b", "decode_32k", "single"),
                ("tinyllama-1.1b", "train:4:256", "one"))
DRYRUN_TIMEOUT = 300
# phase 15: the zoo at published widths: phi3-mini-3.8b and minitron-4b at
# full depth, jamba-v0.1-52b at one period, 8 of its 32 layers (one card
# holds 49.4 GiB of a period in float32; four periods are ~192 GiB)
ZOO_DENSE = ("phi3-mini-3.8b", "minitron-4b")
JAMBA_LAYERS = 8
# phase 16: the rest of the zoo at published widths, cut in depth only
# where float32 parameters would not fit the card: deepseek-v2-236b at 4 of
# 60 layers (1 dense + 3 MoE: 13.30 G parameters, 49.6 GiB), deepseek-v3-
# 671b at 4 of 61 (its 3 dense + 1 MoE of 256 experts, and the MTP head:
# 15.21 G, 56.7 GiB); pixtral-12b (45.6 GiB) and hubert-xlarge (3.5 GiB)
# at full depth
DEEPSEEK_LAYERS = {"deepseek-v2-236b": 4, "deepseek-v3-671b": 4}
ZOO_FULL = ("pixtral-12b", "hubert-xlarge")
MLA_GAP_TOL = 0.05      # absorbed vs naive decode: the reference's bound
MTP_SEQ = 512


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


@contextlib.contextmanager
def recording_shapes():
    """Within the block, every call of the four linear kernels' wrappers
    records its shape key (the grouped kernels' x layout, the public limb
    count) in ``seen[name]`` and its launch request in ``calls``; yields
    ``(seen, calls)``."""
    import repro_torch.kernels.ops as kops

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
    try:
        yield seen, calls
    finally:
        for name, fn in wrappers.items():
            setattr(kops, fn, saved[name])


def path_shapes(net: str, weights: str, binary_linear: str, fused: bool,
                batch: int = BATCH):
    """Shapes (the grouped kernels' x layout, the public limb count) each
    wrapper receives on a path at ``batch``, from a shape-only (meta) run
    of it; and the cost model's kernel requests of the path, which must
    list those launches exactly, in order (the autotuner tunes what they
    name)."""
    from repro_torch.core import cost_model, linear
    from repro_torch.core.secure_model import secure_infer_cost
    from repro_torch.launch.serve_secure import build
    from repro_torch.nn.bnn import INPUT_SHAPES

    linear.set_fused_rounds(fused)
    try:
        with recording_shapes() as (seen, calls):
            model = build(net, device="cpu", weights=weights,
                          binary_linear=binary_linear)
            shape = (batch,) + INPUT_SHAPES[net]
            secure_infer_cost(model, shape)
        reqs = cost_model.model_cost(model, shape).kernel_requests()
    finally:
        linear.set_fused_rounds(True)
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


def check_kernels(shapes: dict, timed: bool = True) -> list:
    """Phase 2: every kernel at every main-path shape == plain version.
    Untimed (phase 13's shapes that phase 2 lacks), each shape is only
    held to its plain version, split-K repeats included, and no row is
    returned."""
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
               "word_bound_ms": 0.0, "first_ms": 0.0}
        first_key = FIRST_DESIGNS.get(name)
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
                first = lambda: grp._launch_bin_grouped(xd, wd, grp.PER_SLOT)
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
            if not timed:
                print(f"[chip_smoke] {name} {desc} x{per_query}: exact"
                      f"{route}")
                continue
            ms = median_ms(run)
            pms = host_ms(plain)
            if plan is not None:   # time the route not taken
                alt = (limbs.CUDA_CORE if plan[0] == limbs.TENSOR_CORE
                       else limbs.TENSOR_CORE)
                if not torch.equal(other(alt), got):
                    fail(f"{name} {desc}: the {alt} route != plain version")
                desc["other_route_ms"] = median_ms(lambda: other(alt))
                route += f"; {alt} {desc['other_route_ms']:.5f} ms"
            if first is not None:   # the first design: one slot a grid row
                label = first_key.replace("_", "-") + " kernel"
                if not torch.equal(first(), got):
                    fail(f"{name} {desc}: the {label} != plain version")
                first_ms = median_ms(first)
                route += f"; {label} {first_ms:.5f} ms"
            b_ms = nbytes / HBM_BPS * 1e3
            o_ms = ops / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({**desc, "per_query": per_query, "ms": ms,
                           "plain_ms": pms, "bound_ms": bound,
                           "bound_by": "bytes" if b_ms >= o_ms else
                           "operations"})
            if first is not None:
                detail[-1][f"{first_key}_ms"] = first_ms
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
                tot["first_ms"] += per_query * first_ms
        if not timed:
            continue
        if not detail:
            fail(f"{name}: no main-path shape was collected")
        print(f"[chip_smoke] {name} over one query of each path: "
              f"{tot['ms']:.5f} ms, bound {tot['bound_ms']:.5f} ms"
              + (f" (weight as int32 words: {tot['word_bound_ms']:.5f} ms)"
                 if tot["word_bound_ms"] else "")
              + (f"; all on the CUDA cores {tot['cuda_core_ms']:.5f} ms"
                 if "cuda_core_ms" in tot else "")
              + (f"; the {first_key.replace('_', '-')} kernel "
                 f"{tot['first_ms']:.5f} ms "
                 f"({tot['first_ms'] / tot['ms']:.2f}x)"
                 if first_key else ""))
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": 0,
               "max_abs_err": tot["err"], "ms": tot["ms"],
               "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
               "bound_by": ("bytes" if tot["bytes_bound_ms"]
                            >= tot["ops_bound_ms"] else "operations"),
               "library_ms": None, "shapes": detail}
        if first_key:
            row[f"{first_key}_ms"] = tot["first_ms"]
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
    row's numbers are TinyLlama's shape (FLASH_ROW), the main path's; the
    wide heads' numbers are in its shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_ref

    g = torch.Generator().manual_seed(7)
    detail, err_max, row = [], 0.0, None
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
              f"{pms:.3f} ms, sdpa {lib:.5f} ms ({ms / lib:.2f}x), max |err| "
              f"{err:.3g}")
        if (b, s, h, hkv, hd, dtype) == FLASH_ROW:
            row = (ms, pms, b_ms, o_ms, lib)
    return _row("flash_attention", *row, err_max, detail)


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
    bad = ((got.double() - want).abs() > tol).nonzero()
    cells = sorted({(int(i), int(j) // chunk, int(k))
                    for i, j, k, _ in bad.tolist()})
    serial = float((ssd._launch(*dev, chunk, "serial").cpu().double()
                    - want).abs().max())
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,uuid,serial",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return (f"vs float64 / max |y|: kernel {f64['kernel']:.3g}, plain "
            f"{f64['plain']:.3g}; {len(bad)} elements in (batch, chunk, "
            f"head) cells {cells[:16]}; serial kernel max abs err "
            f"{serial}; card {r.stdout.strip()}")


def ssd_case(host, chunk: int, reps: int, label: str = "") -> dict:
    """B9 on one input set (host tensors, moved to the card): kernel ==
    plain version (host CPU, in float64) within SSD_REL_TOL of max |y|
    (the float32 plain version's own gap printed beside), ``reps``
    repeats bit-identical, the serial kernel beside it; at chunk CHUNK each
    pass timed alone.  Returns the shape's record (``ms``, ``plain_ms``,
    ``b_ms``, ``o_ms`` and the error among it)."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.nn.ssm import CHUNK

    dev = tuple(t.cuda() for t in host)
    run = lambda: ssd.ssd_scan(*dev, chunk=chunk)
    got = run()
    # the kernel's sums run in a fixed order: a repeat that differs in any
    # bit is a race between its threads
    (b, s, h, hd), n = host[0].shape, host[1].shape[-1]
    for _ in range(reps):
        if not torch.equal(run(), got):
            fail(f"ssd_scan {(b, s, h, hd, n, chunk)}: repeats of one "
                 f"launch differ")
    got = got.cpu()
    t0 = time.perf_counter()
    plain32 = ssd.ssd_scan_ref(*host, chunk=chunk)
    pms = (time.perf_counter() - t0) * 1e3
    # the gate's yardstick: the same chunk math in float64
    want = ssd.ssd_chunked(*host, chunk, dtype=torch.float64)[0]
    err = float((got.double() - want).abs().max())
    scale = float(want.abs().max())
    # each float32 side against it (the plain one printed, not gated)
    f64 = {side: float((t.double() - want).abs().max()) / scale
           for side, t in (("kernel", got), ("plain", plain32))}
    if not err <= SSD_REL_TOL * scale:
        fail(f"ssd_scan {(b, s, h, hd, n, chunk)}: kernel != plain "
             f"version (max abs err {err}, max |y| {scale}); "
             + ssd_diagnosis(ssd, dev, got, want, f64, chunk,
                             SSD_REL_TOL * scale))
    ms = median_ms(run)
    # the serial kernel (one block per (head, batch) walks the chunks)
    old_run = lambda: ssd._launch(*dev, chunk, "serial")
    old_err = float((old_run().cpu().double() - want).abs().max())
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
    # across heads); per (b, h, chunk): its decayed product with x·dt, the
    # carried-state term and the state update
    tri = chunk * (chunk + 1) // 2
    ops = 2 * b * (s // chunk) * (tri * n + h * (tri * hd
                                                  + 2 * chunk * n * hd))
    o_ms = ops / FP32_OPS * 1e3
    print(f"[chip_smoke] ssd_scan {label}{(b, s, h, hd, n)} chunk {chunk}: "
          f"{ms:.5f} ms (bound {max(b_ms, o_ms):.5f} ms, "
          f"{100 * max(b_ms, o_ms) / ms:.1f}% of bound), plain on host "
          f"{pms:.3f} ms, max |err| {err:.3g} (max |y| {scale:.3g}; "
          f"vs float64 / max |y|: kernel {f64['kernel']:.3g}, plain "
          f"{f64['plain']:.3g}); "
          f"{reps} repeats bit-identical; serial kernel {old_ms:.5f} ms "
          f"({old_ms / ms:.1f}x)"
          + "".join(f"; {k} {v:.5f} ms" for k, v in passes.items()))
    return {"B": b, "S": s, "H": h, "hd": hd, "N": n, "chunk": chunk,
            "ms": ms, "plain_ms": pms, "bound_ms": max(b_ms, o_ms),
            "b_ms": b_ms, "o_ms": o_ms, "max_abs_err": err,
            "max_abs_y": scale, "repeats": reps, "serial_ms": old_ms,
            "pass_ms": passes, "rel_err_vs_float64": f64}


def check_ssd(layer_inputs) -> dict:
    """Phase 8, B9: kernel == plain version (host CPU) at the reference's
    test shapes and at Mamba2-1.3B's layer inputs at batch 1 and 2 (the
    row's numbers), each beside the serial kernel; at the layer shapes each
    pass is also timed alone."""
    import torch
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
    detail = [ssd_case(*case) for case in cases]
    last = detail[-1]
    # no single PyTorch call computes the SSD scan
    row = _row("ssd_scan", last["ms"], last["plain_ms"], last["b_ms"],
               last["o_ms"], None, max(d["max_abs_err"] for d in detail),
               detail)
    row["serial_ms"], row["pass_ms"] = last["serial_ms"], last["pass_ms"]
    return row


def lm_tokens(vocab: int):
    import torch
    return torch.randint(0, vocab, (LM_BATCH, LM_SEQ),
                         generator=torch.Generator().manual_seed(1)).cuda()


def print_serve(st, cfg) -> None:
    """One serve's numbers; the tokens must be in range and of the asked
    shape, every sampled token's logits finite.  Its decode step joins
    phase 17's roofline table."""
    vocab = cfg.vocab
    if st["decode_steps"]:
        STEP_TIMES.append((f"{cfg.name} decode", cfg,
                           {"kind": "decode", "global_batch": st["batch"],
                            "seq_len": st["prompt_len"] + st["gen"]},
                           st["decode_s"] / st["decode_steps"]))
    toks = st["tokens"]
    if toks.shape != (SERVE["batch"], SERVE["gen"]):
        fail(f"{st['arch']} served tokens of shape {toks.shape}")
    if not ((toks >= 0) & (toks < vocab)).all() or not st["logits_finite"]:
        fail(f"{st['arch']} served tokens out of range or non-finite "
             f"logits")
    print(f"[chip_smoke] serve {st['arch']} batch {st['batch']} prompt "
          f"{st['prompt_len']} gen {st['gen']} on {st['kind']}: prefill "
          f"{st['prefill_tok_s']:.1f} tok/s ({st['prefill_s']:.4f} s), "
          f"decode {st['decode_tok_s']:.1f} tok/s ({st['decode_s']:.4f} s), "
          f"peak memory {st['peak_mem_bytes'] / 2**30:.3f} GiB")


def lm_batch(cfg, batch: int = LM_BATCH) -> dict:
    """A prefill batch of ``batch`` x LM_SEQ positions on the card, from
    seeds: tokens; for audio N(0, 1) bf16 frames; for vision N(0, 1) bf16
    patch embeddings in the first n_patches slots, then tokens."""
    import torch
    gen = torch.Generator().manual_seed(1)
    if cfg.frontend == "audio":
        return {"frames": torch.randn((batch, LM_SEQ, cfg.d_model),
                                      generator=gen).bfloat16().cuda()}
    st = LM_SEQ - cfg.n_patches
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, st),
                                   generator=gen).cuda()}
    if cfg.frontend == "vision":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.n_patches, cfg.d_model), generator=gen) \
            .bfloat16().cuda()
    return out


def prefill_routes(kbuild, params, cfg, gate: bool = True, batch=None):
    """The prefill step at LM_BATCH x LM_SEQ (or on ``batch``, from
    lm_batch) on the _sdpa route and through
    flash_impl=flash_attention_op: the flash route launches B8 exactly once
    a causal GQA layer (none for MLA or an encoder) and nothing else, the
    _sdpa route nothing; the last-position logits of the two are within
    LM_TOL of their scale (``gate``) or only printed.  Returns ({route:
    logits}, {route: the MoE calls' routing}, the flash route's
    launches)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn import moe

    batch = batch or {"tokens": lm_tokens(cfg.vocab)}
    first = next(iter(batch.values()))
    n_batch, n_tok = first.shape[0], LM_SEQ * first.shape[0]
    if cfg.mla or cfg.encoder_only:
        n_attn = 0
    else:
        n_attn = cfg.n_layers // cfg.attn_period if cfg.attn_period \
            else cfg.n_layers
    routes = {"sdpa": make_prefill_step(cfg),
              "flash": make_prefill_step(cfg,
                                         flash_impl=kops.flash_attention_op)}
    out, routing, secs = {}, {}, {}
    for name, step in routes.items():
        step(params, batch)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        with moe.record_routing() as routing[name]:
            t0 = time.perf_counter()
            out[name] = step(params, batch).float()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        STEP_TIMES.append((f"{cfg.name} prefill ({name})", cfg,
                           {"kind": "prefill", "global_batch": n_batch,
                            "seq_len": LM_SEQ}, secs[name]))
        counts = launched(kbuild)
        want = {"flash_attention": n_attn} if name == "flash" and n_attn \
            else {}
        if counts != want:
            fail(f"{cfg.name} prefill ({name}) launched {counts}, want "
                 f"{want}")
        print(f"[chip_smoke] {cfg.name} prefill step {n_batch}x{LM_SEQ} "
              f"({name} route): {secs[name]:.4f} s = "
              f"{n_tok / secs[name]:.0f} tok/s, launches "
              f"{counts}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    got, want = out["flash"], out["sdpa"]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if got.shape != (n_batch, cfg.vocab) or not torch.isfinite(got).all() \
            or not torch.isfinite(want).all() \
            or (gate and not err <= LM_TOL * scale):
        fail(f"{cfg.name} prefill: flash route differs from the _sdpa route "
             f"by {err} (logits scale {scale})")
    print(f"[chip_smoke] {cfg.name} last-position logits: flash route vs "
          f"_sdpa route max |err| {err:.4g} of scale {scale:.4g} "
          f"({100 * err / scale:.2f}%{'' if gate else ', not gated'})")
    return out, routing, {"flash_attention": n_attn} if n_attn else {}


def tinyllama_phase(kbuild, params, cfg) -> dict:
    """Phase 9: TinyLlama-1.1B's prefill step on B8 (22 launches) == the
    _sdpa route; then serve."""
    from repro_torch.launch.serve import serve

    _, _, counts = prefill_routes(kbuild, params, cfg)
    print_serve(serve("tinyllama-1.1b", device="cuda", params=params,
                      **SERVE), cfg)
    return counts


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
    print_serve(serve("mamba2-1.3b", device="cuda", params=params,
                      **SERVE), cfg)
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
    """Phase 11 (card == CPU): at SLM's widths and 2 blocks, a prompt of 2
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
               "o": 0.0, "first_ms": 0.0}
        detail = []
        for key, per in sorted(shapes.items()):
            plan = first = None
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
                first = lambda: grp._launch(xd, wd, grp.FIRST_PAIR, xnd)
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
            if first is not None:   # the pair entry's first design
                if not torch.equal(first(), got):
                    fail(f"{name} {desc}: the first pair kernel != plain "
                         f"version")
                first_ms = median_ms(first)
                route += f"; the first pair kernel {first_ms:.5f} ms"
                tot["first_ms"] += per * first_ms
            ms, st_ms = median_ms(run), median_ms(stacked)
            pms = host_ms(plain)
            b_ms, o_ms = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
            bound = max(b_ms, o_ms)
            detail.append({**desc, "per_rank_query": per, "ms": ms,
                           "stacked_s1_ms": st_ms, "plain_ms": pms,
                           "bound_ms": bound})
            if first is not None:
                detail[-1]["first_pair_ms"] = first_ms
            print(f"[chip_smoke] {name} {desc} x{per}/rank: {ms:.5f} ms, the "
                  f"stacked entry at S = 1 {st_ms:.5f} ms (bound "
                  f"{bound:.5f} ms, {100 * bound / ms:.1f}%), plain on host "
                  f"{pms:.3f} ms, exact{route}")
            tot["ms"] += per * ms
            tot["stacked_ms"] += per * st_ms
            tot["plain_ms"] += per * pms
            tot["b"] += per * b_ms
            tot["o"] += per * o_ms
        bound = max(tot["b"], tot["o"])
        print(f"[chip_smoke] {name} over one rank's query of each mesh path "
              f"and an LM token: {tot['ms']:.5f} ms, the stacked entry "
              f"{tot['stacked_ms']:.5f} ms, bound {bound:.5f} ms "
              f"({100 * bound / tot['ms']:.1f}%)"
              + (f"; the first pair kernel {tot['first_ms']:.5f} ms "
                 f"({tot['first_ms'] / tot['ms']:.2f}x)"
                 if tot["first_ms"] else ""))
        row = _row(name, tot["ms"], tot["plain_ms"], tot["b"], tot["o"],
                   None, 0, detail)
        row["stacked_ms"] = tot["stacked_ms"]
        if tot["first_ms"]:
            row["first_pair_ms"] = tot["first_ms"]
        rows.append(row)
    check_mesh_public(paths[MESH_PUBLIC]["bin_grouped_matmul"], words)
    return rows


def check_mesh_public(shapes: dict, words) -> None:
    """Phase 12: B4 at the shapes a rank of the mesh's public path gives
    it, its pair of slots (S = 2), == its plain version exactly, timed
    beside its first design, the per-slot kernel.  Prints each shape and
    the sum over one rank's query."""
    import torch
    from repro_torch.kernels import bin_rss_matmul as grp

    g = torch.Generator().manual_seed(2)
    tot = {"ms": 0.0, "first_ms": 0.0, "bound_ms": 0.0}
    for ((_, c, m, k), n, c_contig, n_limbs), per in sorted(shapes.items()):
        s = 2
        x, xd = _grouped_x(words, s, c, m, k, c_contig)
        half = 1 << (8 * n_limbs - 2)   # minimal limb count at most L
        wl = grp.public_grouped_limbs(torch.randint(
            -half, half, (c, k, n), dtype=torch.int32, generator=g), n_limbs)
        wd = on_card(wl)
        run = lambda: grp.bin_grouped_matmul_parts(xd, wd)
        first = lambda: grp._launch_bin_grouped(xd, wd, grp.PER_SLOT)
        want = grp.bin_grouped_matmul_ref(x, wl)
        desc = {"S": s, "C": c, "M": m, "K": k, "N": n, "L": n_limbs}
        for what, fn in (("kernel", run), ("per-slot kernel", first)):
            if not torch.equal(fn().cpu(), want):
                fail(f"bin_grouped_matmul {desc}: the {what} != plain version")
        ms, first_ms = median_ms(run), median_ms(first)
        nbytes = 4 * s * c * m * k + c * k * n * n_limbs + 4 * s * c * m * n
        bound = nbytes / HBM_BPS * 1e3
        print(f"[chip_smoke] bin_grouped_matmul {desc} x{per}/rank: "
              f"{ms:.5f} ms (bound {bound:.5f} ms, {100 * bound / ms:.1f}% "
              f"of bound), exact; per-slot kernel {first_ms:.5f} ms")
        tot["ms"] += per * ms
        tot["first_ms"] += per * first_ms
        tot["bound_ms"] += per * bound
    if not tot["ms"]:
        fail("bin_grouped_matmul: the mesh's public path gave no shape")
    print(f"[chip_smoke] bin_grouped_matmul over one rank's query of the "
          f"mesh's public path: {tot['ms']:.5f} ms, bound "
          f"{tot['bound_ms']:.5f} ms ({100 * tot['bound_ms'] / tot['ms']:.1f}"
          f"%); the per-slot kernel {tot['first_ms']:.5f} ms "
          f"({tot['first_ms'] / tot['ms']:.2f}x)")


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
            NOTES[f"mesh CifarNet2 {weights}"] = qps["mesh"]
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
        NOTES["mesh MnistNet1 verify full"] = [ver["query_per_s"]]
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


# ---------------------------------------------------------------------------
# 13. distillation: the customization pipeline
# ---------------------------------------------------------------------------

def distill_phase(kbuild, checked: dict) -> dict:
    """Phase 13: ``run_pipeline`` at the reference's defaults on the card,
    every row beside BENCH_pareto.json's.  Each secure evaluation runs
    with the launch counts zeroed before and read after: it must launch
    exactly its meta run's kernels, once a query of the path's count per
    batch; its first batch's logits must equal the same batch on the CPU
    bit for bit, and its secure accuracy the plaintext ``evaluate`` on
    the same images.  Training runs with torch's deterministic algorithms.  The
    shapes B1-B4 are given there that are not in ``checked`` (phase 2's)
    are held to their plain versions after the pipeline.  Returns the
    secure evaluations' launches."""
    import hashlib

    import numpy as np
    import torch
    from repro_torch.distill import kd, pipeline
    from repro_torch.nn import bnn

    ref = {(r["net"], r["mode"]): r for r in json.loads(
        (ROOT / "BENCH_pareto.json").read_text())["rows"]}
    modes = {json.dumps(kw, sort_keys=True): m
             for m, kw in pipeline.MODES.items()}
    n_eval = abs(DISTILL["secure_eval_size"])
    per_query = {}
    for fam in pipeline.FAMILIES.values():
        for net, _ in fam["students"]:
            for mode, kw in pipeline.MODES.items():
                seen, _ = path_shapes(net, kw.get("weights", "shared"),
                                      kw.get("binary_linear", "auto"), True,
                                      batch=DISTILL_EVAL_BATCH)
                per_query[(net, mode)] = {
                    name: sum(d.values()) for name, d in seen.items() if d}
    secs = {"train": 0.0, "compile": 0.0, "secure": 0.0, "cpu": 0.0}
    evals, launches = {}, {}
    outs = []          # the logits of the secure evaluation in progress
    ran = {name: {} for name in LINEAR_KERNELS}   # the shapes given to B1-B4

    def timed(what, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[what] += time.perf_counter() - t0
            return out
        return run

    secure_accuracy = pipeline._secure_accuracy

    def counted(params, net, x, y, *, mode_kw, **kw):
        mode = modes[json.dumps(mode_kw, sort_keys=True)]
        outs.clear()
        kbuild.reset_launches()
        with recording_shapes() as (seen, _):
            acc = secure_accuracy(params, net, x, y, mode_kw=mode_kw, **kw)
        got = launched(kbuild)
        if {k: sum(d.values()) for k, d in seen.items() if d} != got:
            fail(f"distill {net} {mode}: the recorded wrapper calls {seen} "
                 f"do not account for the launches {got}")
        for name, d in seen.items():
            for key, c in d.items():
                ran[name][key] = ran[name].get(key, 0) + c
        queries = -(-len(x) // DISTILL_EVAL_BATCH)
        want = {k: queries * c for k, c in per_query[(net, mode)].items()}
        if got != want:
            fail(f"distill {net} {mode}: the secure evaluation launched "
                 f"{got}, its meta run calls {want}")
        for k, c in got.items():
            launches[k] = launches.get(k, 0) + c
        card = np.concatenate(outs)
        # the first batch again on the CPU: the port's CPU path, which
        # the tests hold bit for bit to the reference's _secure_accuracy
        # (the same keys: batch 0's parties, input shares and weights)
        outs.clear()
        t0 = time.perf_counter()
        host = {k: v.cpu() for k, v in params.items()}
        pipeline.compile_secure = saved["compile_secure"]
        pipeline.secure_infer = capture
        try:
            secure_accuracy(host, net, x[:DISTILL_EVAL_BATCH],
                            y[:DISTILL_EVAL_BATCH], mode_kw=mode_kw, **kw)
        finally:
            pipeline.compile_secure = card_compile
            pipeline.secure_infer = card_secure
        secs["cpu"] += time.perf_counter() - t0
        cpu = np.concatenate(outs)
        if not np.array_equal(card[:len(cpu)], cpu):
            err = np.abs(card[:len(cpu)].astype(np.float64) - cpu).max()
            fail(f"distill {net} {mode}: the card's secure logits differ "
                 f"from the CPU's on the same weights and images, max "
                 f"{err:.6g}")
        with torch.no_grad():
            plain, _ = bnn.bnn_forward(params, torch.as_tensor(
                x, device=next(iter(params.values())).device), net)
        evals[(net, mode)] = (acc, kd.evaluate(params, net, x, y),
                              card, plain.cpu().numpy())
        return acc

    saved = {k: getattr(pipeline, k) for k in (
        "train_bnn", "compile_secure", "secure_infer_cost", "secure_infer",
        "_secure_accuracy")}

    def train(net, data, **kw):
        before = secs["train"]
        torch.use_deterministic_algorithms(True)
        try:
            res = timed("train", saved["train_bnn"])(net, data, **kw)
        finally:
            torch.use_deterministic_algorithms(False)
        digest = hashlib.sha256()
        for k in sorted(res.params):
            digest.update(res.params[k].detach().cpu().numpy().tobytes())
        print(f"[chip_smoke] distill train {net}: "
              f"{secs['train'] - before:.2f} s, history {res.history}, "
              f"params sha256 {digest.hexdigest()[:16]}")
        return res

    def capture(*a, **kw):
        out = saved["secure_infer"](*a, **kw)
        outs.append(out.cpu().numpy())
        return out

    timed_secure = timed("secure", saved["secure_infer"])

    def card_secure(*a, **kw):
        out = timed_secure(*a, **kw)
        outs.append(out.cpu().numpy())
        return out

    card_compile = timed("compile", saved["compile_secure"])
    pipeline.train_bnn = train
    pipeline.compile_secure = card_compile
    pipeline.secure_infer_cost = timed("compile",
                                       saved["secure_infer_cost"])
    pipeline.secure_infer = card_secure
    pipeline._secure_accuracy = counted
    t0 = time.perf_counter()
    try:
        result = pipeline.run_pipeline(device="cuda", **DISTILL)
    finally:
        for k, fn in saved.items():
            setattr(pipeline, k, fn)
    total = time.perf_counter() - t0
    rows = result["rows"]
    if len(rows) != 18:
        fail(f"distill: {len(rows)} rows, want 18")
    print(f"[chip_smoke] distill rows (card | BENCH_pareto.json): "
          f"net mode acc secure_acc params online_kb rounds postsign_kb")
    for r in rows:
        key = (r["net"], r["mode"])
        b = ref[key]
        sec, plain, s_logits, p_logits = evals[key]
        top2 = np.sort(p_logits, -1)
        margin = top2[:, -1] - top2[:, -2]       # plaintext top-2 margin
        gap = np.abs(s_logits - p_logits).max(-1)
        print(f"[chip_smoke] distill {r['net']:13s} {r['mode']:6s} "
              f"acc {r['acc']:.3f} | {b['acc']:.3f}  secure "
              f"{r['secure_acc']:.4f} (plain {plain:.4f}) | "
              f"{b['secure_acc']}  params {r['params']} | {b['params']}  "
              f"KB {r['online_kb']} | {b['online_kb']}  rounds "
              f"{r['rounds']} | {b['rounds']}  post-Sign KB "
              f"{r['postsign_kb']} | {b['postsign_kb']}  pareto "
              f"{r['pareto']} | {b['pareto']}  least margin "
              f"{margin.min():.4f}, most |secure - plain| {gap.max():.4f}")
        if not (math.isfinite(r["acc"])
                and r["secure_acc"] == sec == plain):
            bad = np.nonzero(s_logits.argmax(-1) != p_logits.argmax(-1))[0]
            fail(f"distill {key}: secure accuracy {sec} != plaintext "
                 f"accuracy {plain} on the same {n_eval} images; on the "
                 f"first {DISTILL_EVAL_BATCH} the card's secure logits "
                 f"equal the CPU's; images "
                 f"{bad.tolist()} change their argmax: plaintext top-2 "
                 f"margin {margin[bad].tolist()}, largest |secure - "
                 f"plain| logit {gap[bad].tolist()}")
        if r["acc"] < b["acc"] - DISTILL_ACC_TOL:
            fail(f"distill {key}: accuracy {r['acc']} is more than "
                 f"{DISTILL_ACC_TOL} below the reference's {b['acc']}")
        # the BN folds change no message: these do not depend on the
        # trained values
        for col in ("params", "online_kb", "rounds", "postsign_kb"):
            if r[col] != b[col]:
                fail(f"distill {key}: {col} {r[col]} != the reference's "
                     f"{b[col]}")
    print(f"[chip_smoke] distill: {total:.1f} s (training "
          f"{secs['train']:.1f} s, compiling and meta runs "
          f"{secs['compile']:.1f} s, secure queries {secs['secure']:.1f} s, "
          f"each first batch again on the CPU {secs['cpu']:.1f} s, == the "
          f"card's bit for bit); secure launches {launches}")
    new = {name: {k: c for k, c in d.items() if k not in checked[name]}
           for name, d in ran.items()}
    t0 = time.perf_counter()
    check_kernels(new, timed=False)
    print(f"[chip_smoke] distill: {sum(map(len, new.values()))} of "
          f"{sum(map(len, ran.values()))} kernel shapes not in phase 2, each "
          f"== its plain version ({time.perf_counter() - t0:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# 14. LM training
# ---------------------------------------------------------------------------

def train_lm_phase() -> None:
    """Phase 14: TinyLlama-1.1B's train step at full width and depth on
    ``token_stream`` batches (the loss must fall), then the reduced
    trainer's crash and resume against an uninterrupted run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.launch.profiling import print_profile, profile_once
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.transformer import init_params
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import Trainer, TrainerConfig, latest_step

    cfg = get_config("tinyllama-1.1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, "cuda")
    opt = adamw_init(dict(params.named_parameters()))
    step = make_train_step(cfg, OptConfig(warmup_steps=TRAIN_LM["warmup"]))
    losses, times = [], []
    for batch, s in token_stream(TRAIN_LM["batch"], TRAIN_LM["seq"],
                                 cfg.vocab, seed=0):
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in batch.items()}
        if s >= TRAIN_LM["steps"]:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        print(f"[chip_smoke] train TinyLlama-1.1B step {s}: loss "
              f"{losses[-1]:.4f} grad norm {float(m['grad_norm']):.4f} "
              f"{times[-1]:.4f} s")
    peak = torch.cuda.max_memory_allocated()
    warm = statistics.median(times[1:])
    STEP_TIMES.append(("tinyllama-1.1b train", cfg,
                       {"kind": "train", "global_batch": TRAIN_LM["batch"],
                        "seq_len": TRAIN_LM["seq"]}, warm))
    NOTES["train"] = {"step_s": warm, "peak": peak}
    # one more step (the next batch) under the profiler
    print_profile("chip_smoke", "train step", profile_once(
        lambda: step(params, opt, batch), torch.device("cuda"), warm))
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt, step, m
    torch.cuda.empty_cache()
    toks = TRAIN_LM["batch"] * TRAIN_LM["seq"]
    first3, last3 = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"[chip_smoke] train TinyLlama-1.1B ({cfg.n_layers} blocks, "
          f"{n_params} params) batch {TRAIN_LM['batch']} x "
          f"{TRAIN_LM['seq']}: first step {times[0]:.3f} s, median step "
          f"{warm:.4f} s = {toks / warm:.0f} tok/s, peak memory "
          f"{peak / 2**30:.3f} GiB; loss first 3 {first3:.4f}, last 3 "
          f"{last3:.4f}")
    if not np.isfinite(losses).all() or not last3 < first3:
        fail(f"TinyLlama training: the loss did not fall ({losses})")

    rcfg = cfg.reduced()
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name):
            return Trainer(rcfg, TrainerConfig(ckpt_dir=f"{tmp}/{name}",
                                               **RESUME), device="cuda")
        t0 = time.perf_counter()
        p_ref, _, m_ref = trainer("ref").run(resume=False)
        try:
            trainer("ab").run(resume=False, fail_at_step=4)
            fail("the injected failure did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        last = latest_step(f"{tmp}/ab")
        if last != 4:
            fail(f"the crash at step 4 left checkpoint {last}")
        p_res, _, m_res = trainer("ab").run(resume=True)
        secs = time.perf_counter() - t0
    err = max(float(((a - b).abs() - RESUME_TOL * b.abs()).max())
              for a, b in zip(p_res.parameters(), p_ref.parameters()))
    tail = [m for m in m_ref if m["step"] >= 4]
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(tail, m_res))
    print(f"[chip_smoke] train reduced TinyLlama, crash at step 4 and "
          f"resume vs uninterrupted: params max (|err| - rtol·|ref|) "
          f"{err:.3g}, loss max |err| {loss_err:.3g} ({secs:.1f} s)")
    if len(tail) != len(m_res) or not err <= RESUME_TOL \
            or not loss_err < RESUME_LOSS_TOL:
        fail("the resumed run differs from the uninterrupted one")


# ---------------------------------------------------------------------------
# 15. the zoo: phi3-mini-3.8b, minitron-4b, jamba-v0.1-52b
# ---------------------------------------------------------------------------

def routing_gaps(a: list, b: list) -> tuple:
    """Per MoE call, between two runs' ``record_routing`` lists: the
    (token, choice) decisions whose expert id differs, and those whose
    expert id or kept slot differs (one changed choice moves the slot of
    every later token of its expert)."""
    ids, slots = [], []
    for (ea, pa, ka, _), (eb, pb, kb, _) in zip(a, b):
        slot_a = ka.to(pa.dtype) * (pa + 1)     # 0 where dropped
        slot_b = kb.to(pb.dtype) * (pb + 1)
        ids.append(int((ea != eb).sum()))
        slots.append(int(((ea != eb) | (slot_a != slot_b)).sum()))
    return ids, slots


def jamba_layers(kbuild, params, cfg) -> tuple:
    """Jamba's 2 x 2048 prefill sub-layer by sub-layer: each gets the same
    input on both routes, the plain result is carried on.  The attention
    sub-layer on B8 against _sdpa (within LM_TOL of its scale), each Mamba
    sub-layer's scan on B9 (ssd_inputs -> ssd_scan -> ssd_output) against
    ssd_prefill (within SSD_LAYER_TOL); launches exactly B8 once and B9
    seven times a period.  Returns (the launches, the first Mamba
    sub-layer's scan inputs on the host)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd
    from repro_torch.nn import attention as attn
    from repro_torch.nn import ssm
    from repro_torch.nn import transformer as tfm
    from repro_torch.nn.layers import apply_norm, embed

    tokens = lm_tokens(cfg.vocab)
    errs, layer_in = [], None
    kbuild.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        h = embed(params.embed, tokens)
        for period in params.layers:
            for lp in period.children():
                hin = apply_norm(cfg.norm, lp.norm1, h)
                if lp.is_attn:
                    got, _ = attn.gqa_prefill(
                        lp.attn, hin, cfg, flash_impl=kops.flash_attention_op)
                    want, _ = attn.gqa_prefill(lp.attn, hin, cfg)
                    tol, kind = LM_TOL, "attention"
                else:
                    z, x, bm, cm, da, dt = ssm.ssd_inputs(lp.mamba, hin, cfg)
                    xs = (x.float(), bm.float(), cm.float(), da, dt)
                    if layer_in is None:
                        layer_in = tuple(t.cpu() for t in xs)
                    y = ssd.ssd_scan(*xs, chunk=ssm.CHUNK)
                    got = ssm.ssd_output(lp.mamba, y, x, z, cfg)
                    want, _ = ssm.ssd_prefill(lp.mamba, hin, cfg)
                    tol, kind = SSD_LAYER_TOL, "mamba"
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                errs.append((kind, err / scale))
                if not err <= tol * scale or not torch.isfinite(got).all():
                    fail(f"jamba {kind} sub-layer on its kernel differs "
                         f"from the plain route by {err:.4g} of scale "
                         f"{scale:.4g}")
                h = h + want
                h = h + tfm._ffn_apply(lp.ffn, apply_norm(cfg.norm,
                                                          lp.norm2, h), cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launched(kbuild)
    n_per = cfg.n_layers // cfg.attn_period
    want = {"flash_attention": n_per, "ssd_scan": n_per * (cfg.attn_period
                                                         - 1)}
    if counts != want:
        fail(f"jamba layer by layer launched {counts}, want {want}")
    print(f"[chip_smoke] {cfg.name} prefill {LM_BATCH}x{LM_SEQ} sub-layer "
          f"by sub-layer, each on its kernel and on the plain route: "
          f"{secs:.3f} s, launches {counts}, max |err| / scale: "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs))
    return counts, layer_in


def zoo_phase(kbuild, rows: list) -> dict:
    """Phase 15: phi3-mini-3.8b and minitron-4b at full width and depth,
    jamba-v0.1-52b at full width and JAMBA_LAYERS layers: the prefill step
    on both routes, jamba sub-layer by sub-layer and B9 alone at its layer
    shape, then serve.  One model on the card at a time."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profiling import print_profile
    from repro_torch.launch.serve import serve
    from repro_torch.nn import moe
    from repro_torch.nn.ssm import CHUNK
    from repro_torch.nn.transformer import init_params

    launches = {"flash_attention": 0, "ssd_scan": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    print(f"[chip_smoke] zoo: device memory in use at the start "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    for arch in ZOO_DENSE:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        params = init_params(cfg, 0, "cuda")
        add(prefill_routes(kbuild, params, cfg)[2])
        print_serve(serve(cfg, device="cuda", params=params, **SERVE), cfg)
        del params

    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, name=f"{full.name}-{JAMBA_LAYERS}L",
                              n_layers=JAMBA_LAYERS)
    print(f"[chip_smoke] {full.name} cut to {JAMBA_LAYERS} of "
          f"{full.n_layers} layers: one card holds "
          f"{cfg.param_count() * 4 / 2**30:.1f} GiB of a period in float32; "
          f"{full.n_layers // JAMBA_LAYERS} periods are "
          f"{full.param_count() * 4 / 2**30:.0f} GiB")
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, "cuda")
    out, routing, counts = prefill_routes(kbuild, params, cfg, gate=False)
    add(counts)
    ids, slots = routing_gaps(routing["sdpa"], routing["flash"])
    print(f"[chip_smoke] {cfg.name} routing decisions that differ between "
          f"the routes, by MoE layer (of "
          f"{LM_BATCH * LM_SEQ * cfg.experts_per_tok} each): expert id "
          f"{ids}, expert id or kept slot {slots}")
    counts, layer_in = jamba_layers(kbuild, params, cfg)
    add(counts)
    # B9 alone at jamba's layer shape, within SSD_REL_TOL of its plain
    # version: a shape of the ssd_scan row
    next(r for r in rows if r["name"] == "ssd_scan")["shapes"].append(
        ssd_case(layer_in, CHUNK, 5, "jamba layer "))
    with moe.record_routing() as served:
        st = serve(cfg, device="cuda", params=params, profile=True, **SERVE)
    print_serve(st, cfg)
    kept = sum(int(k.sum()) for _, _, k, _ in served)
    total = sum(int(k.numel()) for _, _, k, _ in served)
    cap = max(1, int(1.25 * SERVE["batch"] * cfg.experts_per_tok
                     / cfg.n_experts))
    print(f"[chip_smoke] {cfg.name} served: {len(served)} MoE calls at "
          f"capacity {cap} a step, {total - kept} of {total} choices "
          f"dropped ({100 * (total - kept) / total:.1f}%)")
    print_profile("chip_smoke", f"{cfg.name} decode step", st["profile"])
    del params, out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 16. the zoo, part 2: deepseek-v2/v3 (MLA), pixtral-12b, hubert-xlarge
# ---------------------------------------------------------------------------

def moe_drops(cfg, calls: list, what: str) -> None:
    """Each MoE layer's capacity and dropped-choice share over ``calls``
    (record_routing lists; layer i's calls are every n-th)."""
    n_moe, k = cfg.n_layers - cfg.dense_layers, cfg.experts_per_tok
    parts = []
    for layer in range(n_moe):
        mine = calls[layer::n_moe]
        kept = sum(int(c[2].sum()) for c in mine)
        total = sum(int(c[2].numel()) for c in mine)
        caps = sorted({max(1, int(1.25 * (c[2].numel() // k) * k
                                  / cfg.n_experts)) for c in mine})
        parts.append(f"layer {cfg.dense_layers + layer}: capacity "
                     f"{'/'.join(map(str, caps))}, {total - kept} of {total} "
                     f"dropped ({100 * (total - kept) / total:.1f}%)")
    print(f"[chip_smoke] {cfg.name} {what}: {len(calls)} MoE calls; "
          + "; ".join(parts))


def mla_decode_gap(params, cfg) -> None:
    """Absorbed against naive MLA decode from serve's prompt (seed 0, SERVE
    sizes): the absorbed run generates greedily and the naive one is fed
    the same tokens and takes the same expert choices (top-k routing is
    discontinuous, and a capacity of 1 a step turns one flipped choice
    into other drops: the reference's test_mla turns MoE off for that);
    every step's logits within MLA_GAP_TOL of their scale (its bound);
    prints the largest gap, the choices the naive run's own router would
    have changed and the first step whose argmax parts."""
    import torch
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.nn import moe
    from repro_torch.nn.transformer import init_cache

    b, plen = SERVE["batch"], SERVE["prompt_len"]
    n = plen + SERVE["gen"] - 1
    prompt = torch.randint(0, cfg.vocab, (b, plen),
                           generator=torch.Generator().manual_seed(0)).cuda()
    runs = {a: (make_decode_step(cfg, mla_absorbed=a),
                init_cache(cfg, b, n, "cuda")) for a in (True, False)}
    worst, parted, toks, flips = 0.0, None, None, 0
    t0 = time.perf_counter()
    for pos in range(n):
        feed = prompt[:, pos:pos + 1] if pos < plen else toks
        lg = {}
        (step_a, cache_a), (step_n, cache_n) = runs[True], runs[False]
        with moe.record_routing() as calls:
            lg[True], _ = step_a(params, cache_a, {"tokens": feed,
                                                   "pos": pos})
        with moe.replay_routing([c[0] for c in calls]) as changed:
            lg[False], _ = step_n(params, cache_n, {"tokens": feed,
                                                    "pos": pos})
        flips += sum(changed)
        err = float((lg[True] - lg[False]).abs().max())
        scale = float(lg[False].abs().max())
        worst = max(worst, err / scale)
        if not err < MLA_GAP_TOL * max(scale, 1.0):
            fail(f"{cfg.name} step {pos}: absorbed MLA decode differs from "
                 f"the naive one by {err} (logits scale {scale})")
        toks = lg[True].argmax(-1)
        if parted is None and pos >= plen - 1 \
                and not torch.equal(toks, lg[False].argmax(-1)):
            parted = pos
    print(f"[chip_smoke] {cfg.name} absorbed vs naive MLA decode, {n} "
          f"steps ({time.perf_counter() - t0:.2f} s): largest gap "
          f"{100 * worst:.3f}% of the logits' scale (bound "
          f"{100 * MLA_GAP_TOL:.0f}%); {flips} of "
          f"{n * SERVE['batch'] * (cfg.n_layers - cfg.dense_layers)} "
          f"(token, MoE layer) choices the naive run's own router would "
          f"change; argmax "
          + ("never parts" if parted is None else f"parts at step {parted}"))


def mtp_loss(params, cfg) -> None:
    """deepseek-v3's loss_fn (CE + MTP_WEIGHT x the MTP head's CE) at
    1 x MTP_SEQ, without gradients: finite, printed beside ln(vocab)."""
    import torch
    from repro_torch.nn.transformer import MTP_WEIGHT, loss_fn

    toks = torch.randint(0, cfg.vocab, (1, MTP_SEQ + 1),
                         generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        loss = float(loss_fn(params, {"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]}, cfg))
    if not math.isfinite(loss):
        fail(f"{cfg.name} MTP loss is {loss}")
    print(f"[chip_smoke] {cfg.name} loss_fn at 1x{MTP_SEQ} with the MTP "
          f"term (weight {MTP_WEIGHT}): {loss:.4f}; ln(vocab) = "
          f"{math.log(cfg.vocab):.4f}, (1 + {MTP_WEIGHT}) ln(vocab) = "
          f"{(1 + MTP_WEIGHT) * math.log(cfg.vocab):.4f}")


def zoo2_phase(kbuild) -> dict:
    """Phase 16: deepseek-v2-236b and deepseek-v3-671b at full width and
    DEEPSEEK_LAYERS layers (prefill on both routes, serve, absorbed vs
    naive decode, MoE drops, v3's decode step profiled and its MTP loss),
    then pixtral-12b and hubert-xlarge at full width and depth (prefill
    on both routes; pixtral served, hubert refused).  One model on the
    card at a time."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.profiling import print_profile
    from repro_torch.launch.serve import serve
    from repro_torch.nn import moe
    from repro_torch.nn.transformer import init_params

    launches = {"flash_attention": 0}
    gib = 2 ** 30

    def start(cfg, full):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        at_start = torch.cuda.memory_allocated() / gib
        params = init_params(cfg, 0, "cuda")
        held = sum(t.numel() for t in params.parameters())
        print(f"[chip_smoke] {cfg.name}: {held / 1e9:.2f} G parameters on "
              f"the card, {held * 4 / gib:.1f} GiB in float32 "
              f"(param_count {cfg.param_count() / 1e9:.2f} G, without "
              f"norms, front_proj and the MTP head; the full {full.name}: "
              f"{full.n_layers} layers, {full.param_count() / 1e9:.2f} G, "
              f"{full.param_count() * 4 / gib:.0f} GiB); device memory in "
              f"use at the start {at_start:.3f} GiB")
        return params

    def peak(cfg):
        print(f"[chip_smoke] {cfg.name}: peak device memory "
              f"{torch.cuda.max_memory_allocated() / gib:.3f} GiB")

    for arch, n_layers in DEEPSEEK_LAYERS.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, name=f"{full.name}-{n_layers}L",
                                  n_layers=n_layers)
        params = start(cfg, full)
        _, routing, counts = prefill_routes(kbuild, params, cfg)
        if counts:
            fail(f"{cfg.name}: MLA took the flash hook ({counts})")
        ids, slots = routing_gaps(routing["sdpa"], routing["flash"])
        if any(ids) or any(slots):
            fail(f"{cfg.name}: the routes routed differently ({ids}, "
                 f"{slots}) though MLA never takes the hook")
        moe_drops(cfg, routing["sdpa"], f"prefill {LM_BATCH}x{LM_SEQ}")
        with moe.record_routing() as served:
            st = serve(cfg, device="cuda", params=params,
                       profile=cfg.mtp, **SERVE)
        print_serve(st, cfg)
        moe_drops(cfg, served, "served")
        if st["profile"] is not None:
            print_profile("chip_smoke", f"{cfg.name} decode step",
                          st["profile"])
        mla_decode_gap(params, cfg)
        if cfg.mtp:
            mtp_loss(params, cfg)
        peak(cfg)
        del params

    for arch in ZOO_FULL:
        cfg = get_config(arch)
        params = start(cfg, cfg)
        out, _, counts = prefill_routes(kbuild, params, cfg,
                                        batch=lm_batch(cfg))
        for k, v in counts.items():
            launches[k] += v
        if cfg.supports_decode:
            print_serve(serve(cfg, device="cuda", params=params, **SERVE), cfg)
        else:
            try:
                serve(cfg, device="cuda", params=params, **SERVE)
                fail(f"{cfg.name} served, but it is encoder-only")
            except ValueError as e:
                print(f"[chip_smoke] {cfg.name}: serve refused ({e})")
        peak(cfg)
        del params, out
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 17. the launchers, the roofline, the batch axis
# ---------------------------------------------------------------------------

def nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def roofline_phase() -> None:
    """Phase 17 (1): the roofline terms of every LM step phases 10 and
    14-16 timed, and the measured model-FLOPs share; a share above
    SHARE_GATE fails."""
    from repro_torch.roofline.analyze import model_flops, roofline_terms
    if not STEP_TIMES:
        fail("no LM step was timed before the roofline phase")
    for label, cfg, shape, secs in STEP_TIMES:
        t = roofline_terms(cfg, shape, None, {}, 1)
        share = model_flops(cfg, shape) / secs / BF16_OPS
        print(f"[chip_smoke] roofline {label} {shape['kind']} "
              f"{shape['global_batch']}x{shape['seq_len']}: "
              f"{secs * 1e3:.3f} ms; bound {t['step_time_bound_s'] * 1e3:.3f}"
              f" ms ({t['dominant']}: compute {t['compute_s'] * 1e3:.3f} ms,"
              f" memory {t['memory_s'] * 1e3:.3f} ms), "
              f"{100 * t['step_time_bound_s'] / secs:.2f}% of bound; "
              f"model FLOPs {t['model_flops_global']:.4g}, share "
              f"{100 * share:.3f}% of 989 TFLOP/s")
        if not share <= SHARE_GATE:
            fail(f"{label}: model-FLOPs share {share:.3f} > {SHARE_GATE}: "
                 f"the FLOP count or the time is wrong")


def batch_axis_phase() -> dict:
    """Phase 17 (2): CifarNet2 shared and MnistNet1 at batch BATCH on 3 x
    BATCH_AXIS_DATA gloo ranks on the card, held to the CPU port's
    batch-axis run bit for bit; each rank's launches exactly one a linear
    layer (and a depthwise half) a query on the pair entries.  Returns
    the ranks' launches, summed."""
    import numpy as np
    from repro_torch.core.party_group import PartyGroup
    from repro_torch.launch.serve_secure import serve
    from repro_torch.nn.bnn import ALL_NETS

    ranks = 3 * BATCH_AXIS_DATA
    cases = (("CifarNet2", "mesh CifarNet2 shared"),
             ("MnistNet1", "mesh MnistNet1 verify full"))
    host = {}
    t0 = time.perf_counter()
    for net, _ in cases:
        host[net] = serve(net, BATCH, 1, device="cpu", backend="mesh",
                          mesh_ranks=ranks)["logits"]
    print(f"[chip_smoke] batch axis: the CPU port's runs on {ranks} ranks "
          f"{time.perf_counter() - t0:.1f} s")
    launches: dict = {}
    with PartyGroup("cuda", timeout=120, deadline=600, ranks=ranks) as g:
        for net, beside in cases:
            spec = ALL_NETS[net]
            per_run = {"rss_matmul_pair": sum(
                l.kind in ("conv", "fc", "sepconv") for l in spec),
                "grouped_rss_matmul_pair": sum(
                    l.kind == "sepconv" for l in spec)}
            per_run = {k: v for k, v in per_run.items() if v}
            st = serve(net, BATCH, MESH_QUERIES, device="cuda",
                       backend="mesh", group=g)
            what = f"{net} shared batch {BATCH}, {ranks} ranks"
            if st["data_shards"] != BATCH_AXIS_DATA:
                fail(f"{what}: {st['data_shards']} data shards")
            if not np.array_equal(st["logits"], host[net]):
                fail(f"{what}: logits != the CPU port's batch-axis run")
            if not st["wire_rel_diff"] < 0.02:
                fail(f"{what}: wire {st['wire_bytes']} vs ledger "
                     f"{st['ledger_bytes']}")
            for r, got in enumerate(st["rank_launches"]):
                got = {k: c for k, c in got.items() if c}
                want = {k: st["mesh_runs"] * c for k, c in per_run.items()}
                if got != want:
                    fail(f"{what}: rank {r} launched {got}, want {want}")
                for k, c in got.items():
                    launches[k] = launches.get(k, 0) + c
            print(f"[chip_smoke] batch axis {what}: {BATCH_AXIS_DATA} data "
                  f"shards, logits == the CPU port's batch-axis run bit "
                  f"for bit; {st['query_per_s']:.4f} q/s (phase 12's "
                  f"party-only {beside}: {NOTES.get(beside)}); wire "
                  f"{st['wire_bytes']:,} B over the ranks "
                  f"{st['rank_wire_bytes']} vs ledger "
                  f"{st['ledger_bytes']:,} B (a shard's x "
                  f"{BATCH_AXIS_DATA}; rel diff {st['wire_rel_diff']:.2e}); "
                  f"staging ms a query "
                  f"{[round(v, 4) for v in st['rank_staging_ms_per_query']]}"
                  f"; rank seconds "
                  f"{[round(v, 5) for v in st['rank_seconds']]}; launches "
                  f"a query (all ranks) {nonzero(st['launches_per_query'])}")
    return launches


def train_steps(cfg, opt_cfg, batches: list, plan, device,
                each_step=contextlib.nullcontext) -> tuple:
    """``len(batches)`` train steps of ``cfg`` from ``init_params(cfg, 0)``
    on ``device``, on ``plan``'s mesh (each rank its shard of every
    batch) or mesh-less (None), each inside ``each_step()``: (the whole
    parameters on the host, each step's loss and gradient norm, the
    median step seconds after the first, the peak bytes)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_train_step
    from repro_torch.nn.transformer import init_params
    from repro_torch.optim import adamw_init

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device)
    if plan is not None:
        mesh_lib.shard_params(params, plan)
    opt = adamw_init(dict(params.named_parameters()), opt_cfg)
    if plan is not None:
        opt = mesh_lib.conform_opt(opt, params, plan)
    step = make_train_step(cfg, opt_cfg, plan)
    metrics, times = [], []
    for b in batches:
        b = {k: v.to(device) for k, v in b.items()}
        if plan is not None:
            b = mesh_lib.local_batch(b, plan)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with each_step():
            params, opt, m = step(params, opt, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    whole = {k: mesh_lib.full(p).detach().cpu()
             for k, p in params.named_parameters()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del params, opt, step
    if cuda:
        torch.cuda.empty_cache()
    return whole, metrics, statistics.median(times[1:]), peak


def train_gap(got: dict, metrics: list, ref: dict, ref_metrics: list,
              atol: float = 0.0) -> tuple:
    """(max over the parameters of |err| - RESUME_TOL·|ref| - atol, the
    losses' max |err|, the gradient norms' max relative gap); a missing
    parameter fails."""
    if set(got) != set(ref):
        fail(f"the sharded step's parameters {sorted(set(got) ^ set(ref))}"
             f" differ from the mesh-less step's")
    err = max(float(((got[k] - v).abs() - RESUME_TOL * v.abs()).max())
              for k, v in ref.items()) - atol
    pairs = list(zip(metrics, ref_metrics))
    return (err, max(abs(a[0] - b[0]) for a, b in pairs),
            max(abs(a[1] - b[1]) / b[1] for a, b in pairs))


def mesh_train_phase(plan) -> None:
    """Phase 17 (3): TinyLlama-1.1B's train step on ``plan``'s (1, 1) mesh
    (parameters and moments DTensors) against the mesh-less step, the same
    batches; step times and peaks beside phase 14's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.optim import OptConfig

    cfg = get_config("tinyllama-1.1b")
    opt_cfg = OptConfig(warmup_steps=MESH_TRAIN["warmup"])
    stream = token_stream(MESH_TRAIN["batch"], MESH_TRAIN["seq"], cfg.vocab,
                          seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for b, _ in (next(stream) for _ in range(MESH_TRAIN["steps"]))]
    ref, ref_metrics, ref_s, ref_peak = train_steps(cfg, opt_cfg, batches,
                                                    None, "cuda")
    got, metrics, secs, peak = train_steps(cfg, opt_cfg, batches, plan,
                                           "cuda")
    err, loss_err, gn_err = train_gap(got, metrics, ref, ref_metrics)
    NOTES["mesh_train_peak"] = peak
    ph14 = NOTES.get("train", {})
    print(f"[chip_smoke] sharded training TinyLlama-1.1B on a (1, 1) "
          f"DeviceMesh, {MESH_TRAIN['batch']} x {MESH_TRAIN['seq']}, "
          f"{MESH_TRAIN['steps']} steps: params max (|err| - rtol·|ref|) "
          f"{err:.3g}, loss max |err| {loss_err:.3g}, gradient norm max "
          f"relative gap {gn_err:.3g}; median step {secs:.4f}"
          f" s (mesh-less here {ref_s:.4f} s, phase 14 "
          f"{ph14.get('step_s', float('nan')):.4f} s); peak memory "
          f"{peak / 2**30:.3f} GiB (mesh-less {ref_peak / 2**30:.3f}, "
          f"phase 14 {ph14.get('peak', 0) / 2**30:.3f})")
    if not err <= RESUME_TOL or not loss_err < RESUME_LOSS_TOL \
            or not gn_err <= GNORM_TOL:
        fail("the sharded train step differs from the mesh-less one")


def moe_shardmap_phase(plan) -> None:
    """Phase 17 (4): one MoE layer at jamba's widths, "shardmap" on
    ``plan`` against "dense", within MOE_TOL of max |y|."""
    import torch
    from repro_torch.launch.context import use_plan
    from repro_torch.nn import moe

    c = MOE_LAYER
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = moe.moe_init(gen, c["d"], c["d_ff"], c["experts"], True,
                     device="cuda")
    x = (torch.randn((c["batch"], c["seq"], c["d"]), generator=gen,
                     device="cuda") * 0.5).bfloat16()
    run = dict(top_k=c["top_k"], act="silu", gated=True,
               capacity_factor=c["capacity"])
    out, secs = {}, {}
    for impl in ("dense", "shardmap", "shardmap", "dense"):
        moe.set_moe_impl(impl)
        try:
            with use_plan(plan), torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[impl] = moe.moe_ffn(p, x, **run).float()
                torch.cuda.synchronize()
                secs.setdefault(impl, []).append(time.perf_counter() - t0)
        finally:
            moe.set_moe_impl("dense")
    err = float((out["shardmap"] - out["dense"]).abs().max())
    scale = float(out["dense"].abs().max())
    print(f"[chip_smoke] MoE layer at jamba's widths ({c['experts']} "
          f"experts, d {c['d']}, d_ff {c['d_ff']}, top-{c['top_k']}, "
          f"capacity factor {c['capacity']}), {c['batch']} x {c['seq']} "
          f"tokens on the (1, 1) mesh: shardmap vs dense max |err| "
          f"{err:.4g} of scale {scale:.4g}; seconds in turns dense "
          f"{[round(v, 4) for v in secs['dense']]} shardmap "
          f"{[round(v, 4) for v in secs['shardmap']]}")
    if not torch.isfinite(out["shardmap"]).all() \
            or not err <= MOE_TOL * scale:
        fail("the shardmap MoE differs from the dense dispatch")
    del p, x, out
    torch.cuda.empty_cache()


def rank_mesh(state, shape: tuple):
    """A rank's ("data", "model") ``DeviceMesh`` of ``shape`` on its
    device, one a shape for the group's life (making one is a collective
    every rank joins)."""
    from repro_torch.launch import mesh as mesh_lib
    meshes = state.setdefault("meshes", {})
    if shape not in meshes:
        meshes[shape] = mesh_lib.make_mesh(shape, ("data", "model"),
                                           state["device"].type)
    return meshes[shape]


def two_rank_moe_task(state, c: dict) -> dict:
    """A rank's "shardmap" MoE on a (1, 2) mesh (its experts' half, the
    tokens of its sequence half sent through the all-to-all) against the
    dense dispatch of the same layer, forward and the experts' gradients
    of the output's sum (its own experts' rows: twice the dense gradient,
    both ranks' sums reaching them; the rest zero)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.context import use_plan
    from repro_torch.nn import moe

    dev = state["device"]
    plan = mesh_lib.Plan(rank_mesh(state, (1, 2)))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.moe_init(gen, c["d"], c["d_ff"], c["experts"], True, device=dev)
    x = (torch.randn((c["batch"], c["seq"], c["d"]), generator=gen,
                     device=dev) * 0.5).bfloat16()
    run = dict(top_k=c["top_k"], act="silu", gated=True,
               capacity_factor=c["capacity"])
    ws = [p.w_up, p.w_gate, p.w_down]
    for w in ws:
        w.requires_grad_(True)
    want = moe.moe_ffn(p, x, **run).float()
    want_g = torch.autograd.grad(want.sum(), ws)
    want = want.detach()
    secs = []
    moe.set_moe_impl("shardmap")
    try:
        with use_plan(plan):
            for _ in range(2):       # the first call sets the collectives up
                t0 = time.perf_counter()
                y = moe.moe_ffn(p, x, **run).float()
                got_g = torch.autograd.grad(y.sum(), ws)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
    finally:
        moe.set_moe_impl("dense")
    y = y.detach()
    e_loc = c["experts"] // 2
    mine = slice(state["rank"] * e_loc, (state["rank"] + 1) * e_loc)
    grad_err, rest = 0.0, 0.0
    for g, w in zip(got_g, want_g):
        scale = float(w.abs().max())
        grad_err = max(grad_err,
                       float((g[mine] / 2 - w[mine]).abs().max()) / scale)
        g = g.clone()
        g[mine] = 0
        rest = max(rest, float(g.abs().max()))
    return {"err": float((y - want).abs().max()),
            "scale": float(want.abs().max()),
            "finite": bool(torch.isfinite(y).all()),
            "grad_err": grad_err, "grad_rest": rest, "seconds": secs,
            "device": str(y.device)}


def two_rank_psum_task(state, g):
    """``int8_psum`` of this rank's row of ``g`` over the whole group, on
    the rank's device; the sum comes back on the host."""
    from repro_torch.optim.compress import int8_psum
    out = int8_psum(g[state["rank"]].to(state["device"]))
    return str(out.device), out.cpu()


@contextlib.contextmanager
def storage_gathers():
    """The all-gathers of the block (``tensor_parallel._gather_on``: on a
    mesh whose "model" axis has one rank, each a leaf's storage shard
    gathered over "data").  Yields {"n"}."""
    from repro_torch.launch import tensor_parallel as tp
    count, gather = {"n": 0}, tp._gather_on

    def counted(*a, **k):
        count["n"] += 1
        return gather(*a, **k)
    tp._gather_on = counted
    try:
        yield count
    finally:
        tp._gather_on = gather


def two_rank_train_task(state, c: dict):
    """TinyLlama at full width and ``c["layers"]`` layers: ``c["steps"]``
    sharded train steps on a (2, 1) mesh (each rank half of every batch,
    each layer's storage shards gathered over "data" for that layer, the
    gradients reduce-scattered back), each step's seconds in collectives
    and storage gathers; rank 0 also runs the mesh-less steps on the
    whole batches and returns both."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import OptConfig

    full = get_config("tinyllama-1.1b")
    cfg = dataclasses.replace(full, name=f"{full.name}-{c['layers']}L",
                              n_layers=c["layers"])
    opt_cfg = OptConfig(warmup_steps=c["warmup"])
    stream = token_stream(c["batch"], c["seq"], cfg.vocab, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b, _ in (next(stream) for _ in range(c["steps"]))]
    plan = mesh_lib.Plan(rank_mesh(state, (2, 1)))
    per_step = []

    @contextlib.contextmanager
    def each_step():
        with collective_seconds() as coll, storage_gathers() as n:
            yield
        per_step.append((coll["s"], n["n"]))
    got = train_steps(cfg, opt_cfg, batches, plan, state["device"],
                      each_step)
    if state["rank"] != 0:
        return None
    return got, per_step, train_steps(cfg, opt_cfg, batches, None,
                                      state["device"])


def lr_sum(opt_cfg, steps: int) -> float:
    """The sum of AdamW's learning rates over the first ``steps`` steps
    (``optim.adamw._schedule``: step t from 0 runs at lr·min(1, (t + 2) /
    warmup))."""
    import torch
    from repro_torch.optim.adamw import _schedule
    return sum(float(_schedule(opt_cfg, torch.tensor(t + 1)))
               for t in range(steps))


def two_rank_phase() -> None:
    """Phase 17 (5): two ranks on the card, one gloo group: the MoE's
    all-to-all and sequence gather, ``int8_psum``'s all-gather and the
    train step's gradient reduce-scatter and parameter gathers on CUDA
    tensors, each held to its one-rank counterpart."""
    import torch
    from repro_torch.core.party_group import PartyGroup
    from repro_torch.optim import OptConfig
    from repro_torch.optim.compress import _quant_rows

    t0 = time.perf_counter()
    with PartyGroup("cuda", timeout=120, deadline=600, ranks=2) as grp:
        c = TWO_RANK_MOE
        for r, o in enumerate(grp.run(two_rank_moe_task, (c,))):
            print(f"[chip_smoke] two ranks, MoE rank {r} ({o['device']}, "
                  f"{c['experts']} experts, d {c['d']}, d_ff {c['d_ff']}, "
                  f"top-{c['top_k']}, capacity factor {c['capacity']}, "
                  f"{c['batch']} x {c['seq']} tokens) on a (1, 2) mesh: "
                  f"shardmap vs dense max |err| {o['err']:.4g} of scale "
                  f"{o['scale']:.4g}; its experts' gradient / 2 vs dense "
                  f"{o['grad_err']:.4g} of scale, other experts' "
                  f"{o['grad_rest']:.3g}; forward + backward "
                  f"{o['seconds'][1]:.4f} s (the first call "
                  f"{o['seconds'][0]:.4f} s)")
            if not o["device"].startswith("cuda") or not o["finite"] \
                    or not o["err"] <= MOE_TOL * o["scale"] \
                    or not o["grad_err"] <= GRAD_TOL or o["grad_rest"] != 0:
                fail(f"the two-rank shardmap MoE differs from dense on "
                     f"rank {r}")

        g = torch.randn(TWO_RANK_PSUM, generator=torch.Generator()
                        .manual_seed(0))
        quant = [_quant_rows(t) for t in g]
        plain = sum(q.float() * sc for q, sc in quant)
        # the card's division by the scalar 127 multiplies by its
        # reciprocal: a row's scale may sit an ulp off the host's, and an
        # element on a rounding tie one int8 step
        steps = sum(sc for _, sc in quant)
        bound = 2 * float(g.abs().max()) / 127
        for r, (dev, got) in enumerate(grp.run(two_rank_psum_task, (g,))):
            err = float((got - g.sum(0)).abs().max())
            off = (got - plain).abs() / steps
            print(f"[chip_smoke] two ranks, int8_psum rank {r} ({dev}) of "
                  f"{TWO_RANK_PSUM[1]} x {TWO_RANK_PSUM[2]}: "
                  f"{int((off > 0).sum())} elements differ from the host's "
                  f"dequantized sum, by at most {float(off.max()):.3g} of "
                  f"their rows' int8 steps; max |err| to the exact sum "
                  f"{err:.4g} (bound 2·max|g|/127 {bound:.4g})")
            if not dev.startswith("cuda") or not float(off.max()) <= 1.001 \
                    or not err <= bound:
                fail(f"two-rank int8_psum on rank {r}")

        c = TWO_RANK_TRAIN
        (got, metrics, secs, peak), per_step, \
            (ref, ref_metrics, ref_s, ref_peak) = \
            grp.run(two_rank_train_task, (c,))[0]
        # a layer's 7 matrices, each gathered in the forward pass and again
        # in its recomputation, and the embedding and the head once each
        want_gathers = 2 * 7 * c["layers"] + 2
        # the halves' bf16 gradients sum in another order: where one is
        # rounding noise, its sign may flip, and AdamW moves that element
        # by about lr a step either way (|m^|/sqrt(v^) <= 1.002 over 3
        # steps at betas 0.9 / 0.95): up to 2·lr_t a step apart
        atol = 2.01 * lr_sum(OptConfig(warmup_steps=c["warmup"]),
                             c["steps"])
        err, loss_err, gn_err = train_gap(got, metrics, ref, ref_metrics,
                                          atol)
        print(f"[chip_smoke] two ranks, sharded training TinyLlama-1.1B at "
              f"{c['layers']} layers on a (2, 1) DeviceMesh, "
              f"{c['batch']} x {c['seq']}, {c['steps']} steps: params max "
              f"(|err| - rtol·|ref| - {atol:.3g}) {err:.3g}, loss max |err| "
              f"{loss_err:.3g}, gradient norm max relative gap "
              f"{gn_err:.3g} ({[round(m[1], 5) for m in metrics]} vs "
              f"{[round(m[1], 5) for m in ref_metrics]}); median step "
              f"{secs:.4f} s (rank 0's mesh-less {ref_s:.4f} s); rank 0's "
              f"peak {peak / 2**30:.3f} GiB (mesh-less "
              f"{ref_peak / 2**30:.3f}, {(ref_peak - peak) / 2**30:.3f} "
              f"GiB more); storage gathers a step "
              f"{[n for _, n in per_step]} (want {want_gathers}), seconds "
              f"in collectives a step {[round(t, 4) for t, _ in per_step]}")
        if not err <= RESUME_TOL or not loss_err < RESUME_LOSS_TOL \
                or not gn_err <= GNORM_TOL:
            fail("the two-rank sharded train step differs from the "
                 "mesh-less one")
        if any(n != want_gathers for _, n in per_step):
            fail(f"the two-rank train step gathered its storage "
                 f"{[n for _, n in per_step]} times a step, want "
                 f"{want_gathers} (one layer at a time)")
    print(f"[chip_smoke] two ranks {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def tp_widths():
    """The widths a rank computes inside the block: the q and kv heads of
    each GQA call, the FFN columns of each MLP and the logits' columns."""
    from repro_torch.nn import attention, layers, transformer
    seen = {k: set() for k in TP_WIDTHS}
    attend, hidden, logits = (attention._attend, layers._hidden,
                              transformer._logits)

    def attend_w(q, k, *a):
        seen["q_heads"].add(q.shape[2])
        seen["kv_heads"].add(k.shape[2])
        return attend(q, k, *a)

    def hidden_w(*a):
        out = hidden(*a)
        seen["ffn"].add(out.shape[-1])
        return out

    def logits_w(*a):
        out = logits(*a)
        seen["vocab"].add(out.shape[-1])
        return out
    attention._attend, layers._hidden, transformer._logits = (
        attend_w, hidden_w, logits_w)
    try:
        yield seen
    finally:
        attention._attend, layers._hidden, transformer._logits = (
            attend, hidden, logits)


@contextlib.contextmanager
def collective_seconds():
    """The host seconds inside the tensor-parallel collectives
    (``tensor_parallel.on_group``) and DTensor moves (``mesh.redistribute``)
    of the block, the card synchronised before and after each: gloo and
    its host copies.  Yields {"s", "calls"}."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import tensor_parallel as tp
    total = {"s": 0.0, "calls": 0}
    on_group, redistribute = tp.on_group, mesh_lib.redistribute

    def timed(fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            total["s"] += time.perf_counter() - t0
            total["calls"] += 1
            return out
        return run
    tp.on_group, mesh_lib.redistribute = timed(on_group), timed(redistribute)
    try:
        yield total
    finally:
        tp.on_group, mesh_lib.redistribute = on_group, redistribute


def leaf_grad_sums(cfg, batch: dict, plan, device) -> dict:
    """Per leaf of ``init_params(cfg, 0)``, this rank's share of (|g|^2,
    |ref|^2, |g - ref|^2) for the gradient of ``loss_fn`` on ``batch``: g
    the tensor-parallel step's own (``steps._mesh_grads`` on ``plan``,
    this rank's "model" shard), ref the same slice of the mesh-less
    gradient; a leaf whole on every rank counts on "model" rank 0 only.
    Summed over the ranks they are the whole leaves' (no gather)."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.nn.layers import trainable
    from repro_torch.nn.transformer import init_params, loss_fn

    params = init_params(cfg, 0, device)
    names = [k for k, _ in params.named_parameters()]
    with trainable(params) as leaves:
        ref = torch.autograd.grad(loss_fn(params, batch, cfg), leaves)
    ref = dict(zip(names, ref))
    params = init_params(cfg, 0, device)
    mesh_lib.shard_params(params, plan)
    _, grads = steps._mesh_grads(params, mesh_lib.local_batch(batch, plan),
                                 cfg, plan)
    m, j = plan.model_size, plan.mesh.get_local_rank("model")
    out = {}
    for k, g in grads.items():
        dim, r = mesh_lib.model_dim(g), ref[k].float()
        g = mesh_lib.model_shard(g).float()
        if dim is not None:
            r = r.narrow(dim, j * r.shape[dim] // m, r.shape[dim] // m)
        w = 1.0 if dim is not None or j == 0 else 0.0
        out[k] = tuple(w * float(x.square().sum())
                       for x in (g, r, g - r))
    del params, grads, ref
    torch.cuda.empty_cache()
    return out


def seeded_cache(cfg, batch: int, seq: int, device, seed: int) -> list:
    """A decode cache of ``cfg`` on ``device``, every leaf N(0, 0.25) from
    ``seed`` (the same on every rank of the card)."""
    import torch
    from repro_torch.nn.transformer import init_cache
    cache = init_cache(cfg, batch, seq, device)
    g = torch.Generator(device=device).manual_seed(seed)

    def fill(tree):
        for v in tree.values():
            if isinstance(v, dict):
                fill(v)
            else:
                v.copy_(torch.randn(v.shape, generator=g, device=device)
                        * 0.5)
    for c in cache:
        fill(c)
    return cache


def lay_cache(cache: list, plan) -> list:
    """A whole cache laid out on ``plan`` by ``cache_specs``."""
    from repro_torch.launch import mesh as mesh_lib
    specs = mesh_lib.cache_specs(cache, plan)

    def lay(tree, spec):
        return {k: lay(v, spec[k]) if isinstance(v, dict)
                else mesh_lib.shard(v, plan, spec[k])
                for k, v in tree.items()}
    return [lay(c, sp) for c, sp in zip(cache, specs)]


def decode_run(cfg, params, cache, positions, plan, device, seed: int,
               mla_absorbed: bool = True) -> dict:
    """``make_decode_step`` at each of ``positions`` in turn (tokens drawn
    from ``seed``; mesh-less where ``plan`` is None, else each rank its
    data shard): each step's float32 logits on the host, the cache, the
    median step seconds and the seconds inside collectives."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_decode_step
    step = make_decode_step(cfg, mla_absorbed, plan)
    b = TP_DECODE["batch"]
    g = torch.Generator().manual_seed(seed)
    out = {"logits": [], "s": [], "coll_s": 0.0}
    for pos in positions:
        toks = torch.randint(0, cfg.vocab, (b, 1), generator=g,
                             dtype=torch.int32).to(device)
        if plan is not None:
            toks = mesh_lib.local_batch({"tokens": toks}, plan)["tokens"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_seconds() as coll:
            logits, cache = step(params, cache, {"tokens": toks, "pos": pos})
        torch.cuda.synchronize()
        out["s"].append(time.perf_counter() - t0)
        out["coll_s"] += coll["s"]
        out["logits"].append(logits.float().cpu())
    out["cache"] = cache
    out["step_s"] = statistics.median(out["s"][1:])
    return out


def written_rows(cache: list, positions, first: int = 0) -> dict:
    """Each sequence leaf's rows at ``positions`` that lie in a cache (or
    a rank's slice of it starting at position ``first``), on the host:
    {(layer, leaf, pos): (B, ...) rows}."""
    rows = {}
    for i, layer in enumerate(cache):
        for k, v in layer.items():
            if k not in ("k", "v", "c_kv", "k_rope"):
                continue
            for pos in positions:
                if first <= pos < first + v.shape[1]:
                    rows[i, k, pos] = v[:, pos - first].float().cpu()
    return rows


def decode_gate(what: str, outs: list, key: str, ref: dict) -> None:
    """Each rank's decode logits within TP_LOGITS_TOL of the mesh-less
    run's scale; its written cache rows of layer 0 (whose input, the
    embedded token, both runs share) within one bf16 ulp of the mesh-less
    rows' scale, every other layer's finite and its gap printed (a deeper
    layer's input carries the stream's roundings: TinyLlama's layer 20
    read 3.05% of its scale); the rest of its cache slice untouched."""
    worst_l = worst_r = worst_0 = 0.0
    for r, o in enumerate(outs):
        d = o[key]
        for got, want in zip(d["logits"], ref["logits"]):
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            worst_l = max(worst_l, err / scale)
            if not err <= TP_LOGITS_TOL * scale:
                fail(f"{what} decode rank {r}: logits {err} off the "
                     f"mesh-less decode's (scale {scale})")
        for k, got in d["rows"].items():
            want = ref["rows"][k]
            scale = float(want.abs().max())
            ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
            err = float((got - want).abs().max())
            worst_r = max(worst_r, err / scale)
            if k[0] == 0:
                worst_0 = max(worst_0, err / ulp)
            if not math.isfinite(err) or k[0] == 0 and not err <= ulp:
                fail(f"{what} decode rank {r}: cache row {k} {err} off the "
                     f"mesh-less row (one bf16 ulp {ulp})")
        if not d["rest_same"]:
            fail(f"{what} decode rank {r}: a cache position no step wrote "
                 f"changed")
    n_rows = sum(len(o[key]["rows"]) for o in outs)
    print(f"[chip_smoke] tensor parallel {what} decode: logits max |err| "
          f"{worst_l:.4g} of scale over {len(ref['logits'])} steps; "
          f"{n_rows} written cache rows (of {len(ref['rows'])}) max "
          f"{worst_r:.4g} of scale, layer 0's {worst_0:.3g} bf16 ulps; "
          f"every other position unchanged; "
          + "; ".join(f"rank {r} {o[key]['step_s']:.4f} s a step "
                      f"(collectives "
                      f"{o[key]['coll_s'] / len(ref['logits']):.4f} s), "
                      f"peak {o[key]['peak'] / 2**30:.3f} GiB"
                      for r, o in enumerate(outs))
          + f"; mesh-less {ref['step_s']:.4f} s a step")


def untouched(shards: list, whole: list, positions, plan) -> bool:
    """Whether every sequence leaf of this rank's cache ``shards`` equals
    the seeded ``whole`` cache's same slice away from ``positions``."""
    import torch
    from repro_torch.launch.steps import _cache_shards
    mine = _cache_shards(shards, plan)
    same = True
    for got, ref in zip(mine, lay_cache(whole, plan)):
        for k, v in got.items():
            if k not in ("k", "v", "c_kv", "k_rope"):
                continue
            first = plan.mesh.get_local_rank("model") * v.shape[1]
            keep = [i for i in range(v.shape[1])
                    if first + i not in positions]
            same &= torch.equal(v[:, keep], ref[k].to_local()[:, keep])
    return same


def tp_decode_part(state, cfg, params, plan, c: dict, seed: int,
                   mla_absorbed: bool = True) -> dict:
    """A rank's tensor-parallel decode of ``c["positions"]`` from the
    seeded cache ``seed`` (``params`` already sharded): logits, its written
    rows, whether the rest is untouched, step seconds, seconds in
    collectives and its peak."""
    import torch
    from repro_torch.launch.steps import _cache_shards
    dev = state["device"]
    torch.cuda.reset_peak_memory_stats()
    whole = seeded_cache(cfg, TP_DECODE["batch"], c["seq"], dev, seed)
    run = decode_run(cfg, params, lay_cache(whole, plan), c["positions"],
                     plan, dev, seed, mla_absorbed)
    first = plan.mesh.get_local_rank("model") * c["seq"] // plan.model_size
    rows = written_rows(_cache_shards(run["cache"], plan), c["positions"],
                        first)
    rest = untouched(run.pop("cache"), whole, c["positions"], plan)
    del whole
    return dict(run, rows=rows, rest_same=rest,
                peak=torch.cuda.max_memory_allocated())


def ref_decode_part(cfg, params, c: dict, device, seed: int,
                    mla_absorbed: bool = True) -> dict:
    """The mesh-less decode of ``tp_decode_part``'s steps."""
    cache = seeded_cache(cfg, TP_DECODE["batch"], c["seq"], device, seed)
    run = decode_run(cfg, params, cache, c["positions"], None, device, seed,
                     mla_absorbed)
    run["rows"] = written_rows(run.pop("cache"), c["positions"])
    return run


def tp_rank_task(state, c: dict) -> dict:
    """Phase 17 (6) on one rank of a (1, 2) mesh: TinyLlama-1.1B's
    tensor-parallel prefill step on B8 (a warm call, then one counted and
    timed), its decode steps (9a: :func:`tp_decode_part`), its shares of
    every leaf's first-step gradient against the mesh-less one
    (:func:`leaf_grad_sums`) and ``c["steps"]`` tensor-parallel train
    steps, the seconds in collectives beside; rank 0 also runs the
    mesh-less B8 prefill, decode and train steps and the gaps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn.transformer import init_params
    from repro_torch.optim import OptConfig

    dev = state["device"]
    cfg = get_config("tinyllama-1.1b")
    plan = mesh_lib.Plan(rank_mesh(state, (1, 2)))
    batch = {"tokens": lm_tokens(cfg.vocab).to(dev)}
    out = {"device": str(dev)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    params = init_params(cfg, 0, dev)
    if state["rank"] == 0:
        step = make_prefill_step(cfg, kops.flash_attention_op)
        step(params, batch)
        ref, out["ref_prefill_s"] = timed(lambda: step(params, batch))
        out["ref_logits"] = ref.float().cpu()
        # (9a): the mesh-less decode on the card
        out["ref_decode"] = ref_decode_part(cfg, params, TP_DECODE, dev, 11)
    mesh_lib.shard_params(params, plan)
    out["decode"] = tp_decode_part(state, cfg, params, plan, TP_DECODE, 11)
    step = make_prefill_step(cfg, kops.flash_attention_op, plan)
    step(params, batch)                   # the first call sets up
    kbuild.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with tp_widths() as seen, collective_seconds() as coll:
        logits, out["prefill_s"] = timed(lambda: step(params, batch))
    out["prefill_coll_s"] = coll["s"]
    out["prefill_launches"] = {k: v for k, v in kbuild.LAUNCHES.items()
                               if v}
    out["prefill_peak"] = torch.cuda.max_memory_allocated()
    out["logits"] = logits.float().cpu()
    out["prefill_widths"] = {k: sorted(v) for k, v in seen.items()}
    del params, step, logits
    torch.cuda.empty_cache()

    opt_cfg = OptConfig(warmup_steps=c["warmup"])
    stream = token_stream(c["batch"], c["seq"], cfg.vocab, seed=0)
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b, _ in (next(stream) for _ in range(c["steps"]))]
    # the first step's gradient, leaf by leaf, against the mesh-less one
    out["leaf_sums"] = leaf_grad_sums(
        cfg, {k: v.to(dev) for k, v in batches[0].items()}, plan, dev)
    coll = []

    @contextlib.contextmanager
    def each_step():
        with collective_seconds() as s:
            yield
        coll.append(s["s"])
    with tp_widths() as seen:
        got, metrics, out["train_s"], out["train_peak"] = train_steps(
            cfg, opt_cfg, batches, plan, dev, each_step)
    out["train_coll_s"] = statistics.median(coll[1:])
    out["train_widths"] = {k: sorted(v) for k, v in seen.items()}
    out["metrics"] = metrics
    if state["rank"] == 0:
        ref, ref_metrics, out["ref_train_s"], out["ref_train_peak"] = \
            train_steps(cfg, opt_cfg, batches, None, dev)
        # where a gradient is rounding noise its sign may differ between
        # the two sum orders: AdamW moves such an element about lr_t a step
        # either way (phase 17 (5))
        atol = 2.01 * lr_sum(opt_cfg, c["steps"])
        out["atol"] = atol
        out["gap"] = train_gap(got, metrics, ref, ref_metrics, atol)
        out["ref_metrics"] = ref_metrics
    return out


def mamba_prefill_b9(cfg, params, tokens, plan=None) -> tuple:
    """Mamba2's prefill with every layer's scan on B9 (each launch held to
    the plain version's float64 evaluation of its inputs within
    SSD_REL_TOL of max |y|), tensor-parallel where ``plan`` is given (the
    stream the rank's sequence slice, each scan on its H/m heads): the
    last position's logits (B, V) and the worst launch's error over max
    |y|."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.launch.context import use_plan
    from repro_torch.nn import ssm
    from repro_torch.nn import transformer as tfm
    from repro_torch.nn.layers import apply_norm
    worst = 0.0
    ctx = contextlib.nullcontext() if plan is None else contextlib.ExitStack()
    with torch.no_grad(), ctx:
        if plan is not None:
            ctx.enter_context(tp.local_params(params, plan, tokens.shape[1]))
            ctx.enter_context(use_plan(plan))
        h = tfm._embed_stream(params, tokens)
        for lp in params.layers:
            hin = apply_norm(cfg.norm, lp.norm1, h)
            z, x, bm, cm, da, dt = ssm.ssd_inputs(lp.mamba, hin, cfg)
            ins = (x.float(), bm.float(), cm.float(), da, dt)
            y = ssd.ssd_scan(*ins, chunk=ssm.CHUNK)
            want = ssd.ssd_chunked(*ins, ssm.CHUNK, dtype=torch.float64)[0]
            scale = float(want.abs().max())
            err = float((y.double() - want).abs().max()) / scale
            worst = max(worst, err)
            if not err <= SSD_REL_TOL:
                fail(f"Mamba2 prefill on B9 at {tuple(x.shape)}: kernel != "
                     f"plain version (float64) by {err:.3g} of max |y|")
            h = h + ssm.ssd_output(lp.mamba, y, x, z, cfg)
        h = apply_norm(cfg.norm, params.final_norm, h)
        logits = tfm._logits(params, h)[:, -1]
        if plan is not None and tfm._vocab_split(params):
            logits = tp.gather_model(logits, 1, False)
    return logits.float().cpu(), worst


def tp_kinds_task(state, c: dict) -> dict:
    """Phase 17 (9b, 9c) on one rank of the (1, 2) mesh: Mamba2-1.3B at
    12 layers (the B9 prefill, counted and timed; decode) and
    deepseek-v2-236b at 2 layers (prefill; absorbed and naive decode),
    each tensor-parallel on the mesh-less run's inputs; rank 0 runs the
    mesh-less card runs first, and deepseek's replay the expert choices
    rank 0 recorded (broadcast to every rank; both decode routes the
    absorbed run's)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn import moe
    from repro_torch.nn.transformer import init_params

    dev = state["device"]
    plan = mesh_lib.Plan(rank_mesh(state, (1, 2)))
    out = {"device": str(dev)}

    def cut(arch, n):
        full = get_config(arch)
        return dataclasses.replace(full, name=f"{full.name}-{n}L",
                                   n_layers=n)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collective_seconds() as coll:
            r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, coll["s"]

    # (9b) Mamba2-1.3B
    cfg = cut("mamba2-1.3b", TP_MAMBA["layers"])
    tokens = lm_tokens(cfg.vocab).to(dev)
    dec = dict(seq=LM_SEQ + 8, positions=TP_MAMBA["positions"])
    params = init_params(cfg, 0, dev)
    if state["rank"] == 0:
        mamba_prefill_b9(cfg, params, tokens)          # warm
        (out["mamba_ref"], _), out["mamba_ref_s"], _ = timed(
            lambda: mamba_prefill_b9(cfg, params, tokens))
        out["mamba_ref_decode"] = ref_decode_part(cfg, params, dec, dev, 12)
    mesh_lib.shard_params(params, plan)
    mamba_prefill_b9(cfg, params, tokens, plan)        # warm
    kbuild.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (out["mamba_logits"], out["mamba_b9_err"]), out["mamba_s"], \
        out["mamba_coll_s"] = timed(
            lambda: mamba_prefill_b9(cfg, params, tokens, plan))
    out["mamba_launches"] = {k: v for k, v in kbuild.LAUNCHES.items() if v}
    out["mamba_peak"] = torch.cuda.max_memory_allocated()
    out["mamba_decode"] = tp_decode_part(state, cfg, params, plan, dec, 12)
    del params
    torch.cuda.empty_cache()

    # (9c) deepseek-v2-236b, the mesh-less expert choices replayed
    cfg = cut("deepseek-v2-236b", TP_DEEPSEEK["layers"])
    dsc = dict(seq=TP_DEEPSEEK["cache"], positions=TP_DEEPSEEK["positions"])
    toks = torch.randint(0, cfg.vocab, (TP_DEEPSEEK["batch"],
                                        TP_DEEPSEEK["seq"]),
                         generator=torch.Generator().manual_seed(13)).to(dev)
    choices = [None, None]
    if state["rank"] == 0:
        params = init_params(cfg, 0, dev)
        step = make_prefill_step(cfg)
        with moe.record_routing() as calls:
            ref, out["ds_ref_s"], _ = timed(
                lambda: step(params, {"tokens": toks}))
        out["ds_ref"] = ref.float().cpu()
        choices[0] = [t[0].cpu() for t in calls]
        with moe.record_routing() as calls:
            out["ds_ref_decode"] = ref_decode_part(cfg, params, dsc, dev, 14)
        choices[1] = [t[0].cpu() for t in calls]
        with moe.replay_routing(list(choices[1])):      # the naive route
            out["ds_ref_naive"] = ref_decode_part(cfg, params, dsc, dev, 14,
                                                  mla_absorbed=False)
        del params, step, ref
        torch.cuda.empty_cache()
    dist.broadcast_object_list(choices, src=0)
    params = init_params(cfg, 0, dev)
    mesh_lib.shard_params(params, plan)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_prefill_step(cfg, None, plan)
    with moe.replay_routing(list(choices[0])) as changed:
        got, out["ds_s"], out["ds_coll_s"] = timed(
            lambda: step(params, {"tokens": toks}))
    out["ds_logits"], out["ds_changed"] = got.float().cpu(), sum(changed)
    out["ds_peak"] = torch.cuda.max_memory_allocated()
    out["ds_experts"] = params.layers[1].ffn.w_up.to_local().shape[0]
    with moe.replay_routing(list(choices[1])) as changed:
        out["ds_decode"] = tp_decode_part(state, cfg, params, plan, dsc, 14)
    out["ds_decode_changed"] = sum(changed)
    with moe.replay_routing(list(choices[1])):
        out["ds_naive"] = tp_decode_part(state, cfg, params, plan, dsc, 14,
                                         mla_absorbed=False)
    del params, step
    torch.cuda.empty_cache()
    return out


def kinds_phase(grp) -> dict:
    """Phase 17 (9b, 9c) on the group's two ranks (:func:`tp_kinds_task`)
    and its gates; returns the ranks' B9 launches, summed."""
    import torch
    t0 = time.perf_counter()
    outs = grp.run(tp_kinds_task, (None,))
    ref = outs[0]
    launches: dict = {}
    for r, o in enumerate(outs):
        if not o["device"].startswith("cuda"):
            fail(f"phase 17 (9) rank {r} ran on {o['device']}")
        want = {"ssd_scan": TP_MAMBA["layers"]}
        if o["mamba_launches"] != want:
            fail(f"tensor-parallel Mamba2 rank {r}: launched "
                 f"{o['mamba_launches']}, want {want}")
        for what, got, ref_l in (("Mamba2", o["mamba_logits"],
                                  ref["mamba_ref"]),
                                 ("deepseek-v2", o["ds_logits"],
                                  ref["ds_ref"])):
            err = float((got - ref_l).abs().max())
            scale = float(ref_l.abs().max())
            if not err <= TP_LOGITS_TOL * scale \
                    or not bool(torch.isfinite(got).all()):
                fail(f"tensor-parallel {what} prefill rank {r}: logits "
                     f"{err} off the mesh-less card run's (scale {scale})")
            print(f"[chip_smoke] tensor parallel rank {r}, {what} prefill "
                  f"vs the mesh-less card run: max |err| {err:.4g} of "
                  f"scale {scale:.4g}")
        if o["ds_experts"] != 80:
            fail(f"deepseek-v2 rank {r} holds {o['ds_experts']} experts, "
                 f"want 80 of 160")
        for k, v in o["mamba_launches"].items():
            launches[k] = launches.get(k, 0) + v
        print(f"[chip_smoke] tensor parallel rank {r}: Mamba2-1.3B "
              f"{TP_MAMBA['layers']} layers prefill {LM_BATCH} x {LM_SEQ} "
              f"with B9 on 32 of 64 heads {o['mamba_s']:.4f} s "
              f"(collectives {o['mamba_coll_s']:.4f} s; mesh-less "
              f"{ref['mamba_ref_s']:.4f} s), launches "
              f"{o['mamba_launches']}, each launch vs float64 max "
              f"{o['mamba_b9_err']:.3g} of max |y|, peak "
              f"{o['mamba_peak'] / 2**30:.3f} GiB; deepseek-v2-236b "
              f"{TP_DEEPSEEK['layers']} layers ({o['ds_experts']} of 160 "
              f"experts) prefill {TP_DEEPSEEK['batch']} x "
              f"{TP_DEEPSEEK['seq']} {o['ds_s']:.4f} s (collectives "
              f"{o['ds_coll_s']:.4f} s; mesh-less {ref['ds_ref_s']:.4f} s), "
              f"peak {o['ds_peak'] / 2**30:.3f} GiB, tokens whose own top-k "
              f"differs from the replayed choice: prefill {o['ds_changed']}"
              f", decode {o['ds_decode_changed']}")
    decode_gate("Mamba2-1.3B", outs, "mamba_decode", ref["mamba_ref_decode"])
    decode_gate("deepseek-v2-236b (absorbed)", outs, "ds_decode",
                ref["ds_ref_decode"])
    decode_gate("deepseek-v2-236b (naive)", outs, "ds_naive",
                ref["ds_ref_naive"])
    for r, o in enumerate(outs):         # the two split routes, same steps
        gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
                for a, b in zip(o["ds_naive"]["logits"],
                                o["ds_decode"]["logits"])]
        print(f"[chip_smoke] tensor parallel rank {r}, deepseek-v2-236b "
              f"naive vs absorbed decode, both split: max |err| over "
              f"max(scale, 1) {[round(g, 5) for g in gaps]} (gate "
              f"{MLA_GAP_TOL})")
        if not max(gaps) < MLA_GAP_TOL:
            fail(f"tensor-parallel deepseek-v2 rank {r}: the naive decode "
                 f"is {max(gaps)} off the absorbed one")
    print(f"[chip_smoke] tensor parallel (9b, 9c) "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def tensor_parallel_phase() -> dict:
    """Phase 17 (6) and (9): TinyLlama-1.1B at full width, tensor-parallel
    over the two ranks of a (1, 2) mesh on the card: the prefill step with
    B8 on each rank's 16 heads (exactly 22 launches a rank a step, the
    last-position logits within TP_LOGITS_TOL of the mesh-less B8
    prefill's scale), each leaf's first-step gradient (its norm within
    GNORM_TOL, the difference within LEAF_GRAD_TOL of its norm) and the
    train step against the mesh-less one (loss, gradient norm,
    parameters); each rank's widths at half; the decode step (9a) and,
    in the same group, Mamba2 and deepseek-v2 (9b, 9c:
    :func:`kinds_phase`).  Returns the ranks' launches, summed."""
    from repro_torch.core.party_group import PartyGroup

    t0 = time.perf_counter()
    c = TP_TRAIN
    with PartyGroup("cuda", timeout=300, deadline=900, ranks=2) as grp:
        outs = grp.run(tp_rank_task, (c,))
        kinds = kinds_phase(grp)
    ref = outs[0]
    decode_gate("TinyLlama-1.1B", outs, "decode", ref["ref_decode"])
    scale = float(ref["ref_logits"].abs().max())
    launches: dict = {}
    for r, o in enumerate(outs):
        err = float((o["logits"] - ref["ref_logits"]).abs().max())
        want = {k: sorted(v) for k, v in TP_WIDTHS.items()}
        print(f"[chip_smoke] tensor parallel rank {r} ({o['device']}), "
              f"TinyLlama-1.1B on a (1, 2) mesh: prefill {LM_BATCH} x "
              f"{LM_SEQ} on B8 {o['prefill_s']:.4f} s (collectives "
              f"{o['prefill_coll_s']:.4f} s; mesh-less "
              f"{ref['ref_prefill_s']:.4f} s), launches "
              f"{o['prefill_launches']}, peak "
              f"{o['prefill_peak'] / 2**30:.3f} GiB, logits vs the "
              f"mesh-less B8 prefill max |err| {err:.4g} of scale "
              f"{scale:.4g}; train {c['batch']} x {c['seq']}: median step "
              f"{o['train_s']:.4f} s (collectives {o['train_coll_s']:.4f} s "
              f"a step; mesh-less {ref['ref_train_s']:.4f} s), peak {o['train_peak'] / 2**30:.3f} GiB (mesh-less "
              f"{ref['ref_train_peak'] / 2**30:.3f}); widths "
              f"{o['train_widths']}")
        if not o["device"].startswith("cuda"):
            fail(f"tensor parallel rank {r} ran on {o['device']}")
        if o["prefill_launches"] != {"flash_attention": 22}:
            fail(f"tensor parallel rank {r}: prefill launched "
                 f"{o['prefill_launches']}, want B8 exactly 22")
        if not err <= TP_LOGITS_TOL * scale:
            fail(f"tensor parallel rank {r}: prefill logits {err} off the "
                 f"mesh-less B8 prefill's (scale {scale})")
        if o["prefill_widths"] != want or o["train_widths"] != want:
            fail(f"tensor parallel rank {r}: widths {o['prefill_widths']} /"
                 f" {o['train_widths']}, want {want}")
        for k, v in o["prefill_launches"].items():
            launches[k] = launches.get(k, 0) + v
    gaps = {}
    for k in ref["leaf_sums"]:
        n_got, n_ref, n_diff = (
            math.sqrt(sum(o["leaf_sums"][k][i] for o in outs))
            for i in range(3))
        gaps[k] = (abs(n_got - n_ref) / n_ref if n_ref else n_got,
                   n_diff / n_ref if n_ref else n_got)
    worst_n = max(gaps, key=lambda k: gaps[k][0])
    worst_d = max(gaps, key=lambda k: gaps[k][1])
    groups = {"norms": [k for k in gaps if "norm" in k],
              "embed": ["embed"], "head": ["head"],
              "attention": [k for k in gaps if ".attn." in k],
              "ffn": [k for k in gaps if ".ffn." in k]}
    print(f"[chip_smoke] tensor parallel first-step gradients, {len(gaps)} "
          f"leaves: norm gap max {gaps[worst_n][0]:.3g} ({worst_n}), "
          f"|g - ref| / |ref| max {gaps[worst_d][1]:.3g} ({worst_d}); by "
          f"group (norm gap, |g - ref| / |ref|) " + ", ".join(
              f"{name} ({max(gaps[k][0] for k in ks):.3g}, "
              f"{max(gaps[k][1] for k in ks):.3g})"
              for name, ks in groups.items() if ks))
    bad = sorted(k for k, (n, d) in gaps.items()
                 if not (n <= GNORM_TOL and d <= LEAF_GRAD_TOL))
    if bad:
        fail(f"tensor parallel first-step gradients of {bad[:8]} differ "
             f"from the mesh-less step's")
    err, loss_err, gn_err = ref["gap"]
    print(f"[chip_smoke] tensor parallel train, {c['steps']} steps: params "
          f"max (|err| - rtol·|ref| - {ref['atol']:.3g}) {err:.3g}, loss max "
          f"|err| {loss_err:.3g}, gradient norm max relative gap "
          f"{gn_err:.3g} ({[round(m[1], 5) for m in ref['metrics']]} vs "
          f"{[round(m[1], 5) for m in ref['ref_metrics']]})")
    if not err <= RESUME_TOL or not loss_err < RESUME_LOSS_TOL \
            or not gn_err <= GNORM_TOL:
        fail("the tensor-parallel train step differs from the mesh-less one")
    for k, v in kinds.items():
        launches[k] = launches.get(k, 0) + v
    print(f"[chip_smoke] tensor parallel {time.perf_counter() - t0:.1f} s")
    return launches


def secure_dryrun_phase(kbuild) -> dict:
    """Phase 17 (7): the secure FFN pair at LM widths in both matmul
    modes and on the fused route; returns its launches."""
    import torch
    from repro_torch.launch import dryrun_secure

    torch.cuda.empty_cache()
    launches0 = dict(kbuild.LAUNCHES)
    res = dryrun_secure.run(SECURE_DRY["tokens"], SECURE_DRY["d"],
                            SECURE_DRY["d_ff"], device="cuda",
                            reps=SECURE_DRY["reps"])
    launches = {k: c - launches0[k] for k, c in kbuild.LAUNCHES.items()
                if c != launches0[k]}
    want = {"paper3": {"ring_matmul": 18}, "opt2": {"ring_matmul": 12},
            "fused": {"rss_matmul": 2}}
    for mode, w in want.items():
        if res[mode]["launches"] != w:
            fail(f"secure dry run {mode}: launched {res[mode]['launches']}"
                 f", want {w}")
    if res["paper3_over_opt2_products"] != 1.5 \
            or res["paper3_over_opt2_macs"] != 1.5:
        fail(f"secure dry run: paper3 / opt2 "
             f"{res['paper3_over_opt2_products']} products, "
             f"{res['paper3_over_opt2_macs']} multiply-adds, not 1.5")
    led = res["opt2"]["ledger"]
    print(f"[chip_smoke] secure FFN pair T {res['tokens']} d {res['d']} "
          f"d_ff {res['d_ff']}: paper3 / opt2 ring products "
          f"{res['paper3']['products']} / {res['opt2']['products']} = "
          f"{res['paper3_over_opt2_products']} (multiply-adds "
          f"{res['paper3']['macs']:.4g} / {res['opt2']['macs']:.4g}); "
          f"seconds paper3 {[round(v, 4) for v in res['paper3']['seconds']]}"
          f" opt2 {[round(v, 4) for v in res['opt2']['seconds']]} (B5 a "
          f"product), fused {[round(v, 4) for v in res['fused']['seconds']]}"
          f" (B1 a matmul); ledger {led['rounds']} rounds / "
          f"{led['bytes']:,} B online, {led['pre_rounds']} / "
          f"{led['pre_bytes']:,} B offline, the same in both modes; "
          f"launches {launches}")
    torch.cuda.empty_cache()
    return launches


def dryrun_start(tmp: str) -> list:
    """Phase 17 (8)'s dry-run cells started together, each a subprocess on
    the host (the fake process group lives for its process) writing its
    record under ``tmp``: [(cell, process)].  They run on one thread each
    at the lowest priority: the parts timed beside them (gloo's host
    copies) keep the host's cores."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--out", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, preexec_fn=lambda: os.nice(19))) for cell in DRYRUN_CELLS]


def dryrun_phase(tmp: str, procs: list) -> None:
    """Phase 17 (8): the dry-run cells that :func:`dryrun_start` started
    (``procs``, writing under ``tmp``) collected; their memory and
    roofline records printed, not gated."""
    end = time.perf_counter() + DRYRUN_TIMEOUT
    for (arch, shape, mesh), proc in procs:
        try:
            _, err = proc.communicate(
                timeout=max(1.0, end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            print(f"[chip_smoke] dry run {arch} {shape} {mesh}: no "
                  f"record within {DRYRUN_TIMEOUT} s (killed)")
            continue
        path = Path(tmp) / (f"{arch}__{shape}__{mesh}__baseline.json"
                            .replace(":", "-"))
        if not path.exists():
            print(f"[chip_smoke] dry run {arch} {shape} {mesh}: exit "
                  f"{proc.returncode}, {err[-400:]}")
            continue
        rec = json.loads(path.read_text())
        if rec["status"] != "OK":
            print(f"[chip_smoke] dry run {arch} {shape} {mesh}: "
                  f"{rec['status']} {rec.get('error', '')[:300]}")
            continue
        mem, roof, colls = rec["memory"], rec["roofline"], \
            rec["collectives"]
        beside = ""
        if mesh == "one" and "mesh_train_peak" in NOTES:
            beside = (f" (the card's (1, 1) mesh step: "
                      f"{NOTES['mesh_train_peak'] / 2**30:.3f} GiB)")
        print(f"[chip_smoke] dry run {arch} {shape} on {rec['n_chips']}"
              f" ranks ({mesh}), tensor-parallel, meta step "
              f"{rec['step_s']} s on the host: a rank's arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB, tracked peak "
              f"{mem['tracked_peak_bytes'] / 2**30:.3f} GiB{beside}; "
              f"collectives {colls.pop('total_bytes'):,} B "
              f"({nonzero({k: v['count'] for k, v in colls.items()})}); "
              f"roofline of the cell over {rec['n_chips']} chips: compute "
              f"{roof['compute_s']:.4g} s, memory {roof['memory_s']:.4g} s, {roof['dominant']}"
              f"-bound, model FLOPs {roof['model_flops_global']:.4g}")


def launch_phase(kbuild) -> dict:
    """Phase 17: (1)-(8) above; returns the kernels' launches by part."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    roofline_phase()
    by_part = {"batch-axis": batch_axis_phase()}
    # (8)'s dry runs on the host beside (3)-(7) on the card (the time
    # limit), collected last; killed if a part fails first
    with tempfile.TemporaryDirectory() as dry:
        procs = dryrun_start(dry)
        try:
            with tempfile.TemporaryDirectory() as tmp:
                dist.init_process_group(
                    "cpu:gloo,cuda:nccl", rank=0, world_size=1,
                    store=dist.FileStore(str(Path(tmp) / "store"), 1))
                try:
                    plan = mesh_lib.Plan(mesh_lib.make_mesh(
                        (1, 1), ("data", "model"), "cuda"))
                    mesh_train_phase(plan)
                    moe_shardmap_phase(plan)
                finally:
                    dist.destroy_process_group()
            torch.cuda.empty_cache()
            two_rank_phase()
            by_part["tensor-parallel"] = tensor_parallel_phase()
            by_part["secure-dryrun"] = secure_dryrun_phase(kbuild)
            dryrun_phase(dry, procs)
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    return by_part


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    global HBM_BPS, INT8_OPS, BF16_OPS, FP32_OPS
    from repro_torch.peaks import BF16_OPS, FP32_OPS, HBM_BPS, INT8_OPS
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
    stems = {}
    for name, log in logs.items():   # one report a source
        stems.setdefault(kbuild.KERNELS[name][0], log)
    for name, log in stems.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line \
                    or "warning" in line:
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

    # -- 13. distillation ----------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_phase["distill"] = distill_phase(kbuild, shapes)
    print(f"[chip_smoke] distill phase {time.perf_counter() - t0:.1f} s")

    # -- 14. LM training -----------------------------------------------------
    t0 = time.perf_counter()
    train_lm_phase()
    print(f"[chip_smoke] train-lm phase {time.perf_counter() - t0:.1f} s")

    # -- 15. the zoo ---------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_phase["zoo"] = zoo_phase(kbuild, rows)
    print(f"[chip_smoke] zoo phase {time.perf_counter() - t0:.1f} s")

    # -- 16. the zoo, part 2 -------------------------------------------------
    t0 = time.perf_counter()
    by_phase["zoo-2"] = zoo2_phase(kbuild)
    print(f"[chip_smoke] zoo-2 phase {time.perf_counter() - t0:.1f} s")

    # -- 17. the launchers, the roofline, the batch axis -------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    by_phase.update(launch_phase(kbuild))
    print(f"[chip_smoke] launch phase {time.perf_counter() - t0:.1f} s")
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
