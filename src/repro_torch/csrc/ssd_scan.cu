// Mamba-2 chunked SSD scan (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_kernel (pallas_call in
// ssd_scan).  x (B, S, H, hd), B and C (B, S, N) shared across heads, da
// and dt (B, S, H), all float32 -> y (B, S, H, hd) float32, contiguous.
// x, B and C are read with a unit last stride, da and dt through strides.
//
// The TPU kernel ran the chunks in order on the grid's last axis and kept
// the (hd, N) state in VMEM scratch between them.  Blocks on Hopper run in
// no order, so the scan is Mamba-2's own chunk decomposition (arXiv
// 2405.21060, section 6), chunks in parallel in every pass but (b):
//
//   (t) B^T, C^T (B, N, S): B and C transposed once, so that every operand
//       below is staged from rows contiguous in memory.
//   (g) gram:   gt[b, c][j][i] = B_j . C_i per (batch, chunk), the causal
//               tiles only, into an L2-resident (B, nc, Q, Q) buffer.  B and
//               C are shared across heads: formed once, not once per head.
//   (a) states: dS_c = sum_j B_j^T (x_j dt_j exp(cum_last - cum_j)) per
//               (batch, head, chunk), an (N, hd) tile, and cum_last.
//   (b) pass:   S = exp(cum_last_c) S + dS_c in chunk order per (batch,
//               head), elementwise; slot c (c > 0) becomes the state before
//               chunk c.
//   (c) scan:   y_c = exp(cum) o (C_c S_{c-1}^T) + ((G_c o L) (x dt)),
//               L_ij = exp(cum_i - cum_j) for j <= i, per (batch, chunk,
//               128 rows, pair of heads).
//
// cum (the inclusive cumsum of da over a chunk) is a block-wide scan in
// float64 (each thread a run of rows, warp shuffles, the warps' totals in
// order), rounded once to float32: the plain version's torch.cumsum also
// accumulates float32 in float64, and passes (a) and (c) compute it with
// the same code, so they agree bit for bit.  No pass uses atomics and every
// sum has a fixed order, so a repeat is bit-identical.
//
// Products: float32 FMAs on register tiles.  A tile block is 256 threads,
// two groups of 4 warps, each group a 128 x 64 output tile: in (a) and (c)
// one head each (a pair of heads a block), in (g) half of each 2 x 16 of N
// (the halves added in a fixed order at the end).  A thread owns an 8 x 8
// block (rows warp*32 + {0..3, 16..19} + 4*(lane/8), columns {0..3, 32..35}
// + 4*(lane%8)): each K step reads two float4 of A and two of B from shared
// memory for 64 FMAs, each a broadcast or 128 contiguous bytes for a
// quarter warp.  K runs in 16-deep slabs staged k-major (A[k][row],
// B[k][col], rows padded by 4 floats) through a 3-slab cp.async ring, in
// 16-byte copies where every row is 16-byte aligned.  The operand shared
// by a pair of heads (B in (a), C in (c)'s state term, C B^T in its
// intra-chunk term) is copied once; each thread then decays its own
// landed C B^T elements for both heads and scales its x rows by dt.  A
// warp skips the intra-chunk slabs wholly above its 32 rows (the causal
// triangle), and the slabs' rows above the diagonal are not read.  Rows
// past Q, N or hd are zero-filled and never stored, so every chunk, hd and
// N runs; only the (Q) vectors grow the shared memory with Q.
//
// What bounds it: float32 operations, ~13 GFLOP at Mamba2-1.3B's layer
// (B 2, S 2048, H 64, hd 64, N 128, Q 256): the causal triangle of C B^T
// once per (batch, chunk), and per head its decayed product with x dt, the
// carried-state term and the chunk state, at 67 TFLOP/s on the CUDA cores
// (0.195 ms).  Its bytes (x read once, y written once, ~134 MB) take 0.04
// ms.  The tile loop alone runs well above the passes' rate: the slabs'
// copies, the decay transform and a barrier every 16 K steps are what
// hold them back (PERF.md).
//
// The earlier serial kernel (serial_kernel below: one block per (head,
// batch) walks the chunks in order, both FMA operands from shared memory)
// stays for chip_smoke.py to time beside the passes; no path launches it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---------------------------------------------------------------------------
// The chunk-parallel passes
// ---------------------------------------------------------------------------

constexpr int T = 256;          // threads of a tile block: two groups
constexpr int GT = 128;         // threads of a group: 4 warps
constexpr int RT = 128;         // rows of a group's tile, 32 a warp
constexpr int CT = 64;          // columns of a group's tile
constexpr int BK = 16;          // K of a shared-memory slab
constexpr int STAGES = 3;       // slabs in flight
constexpr int AP = RT + 4;      // slab pitches (16-byte rows)
constexpr int BP = CT + 4;
constexpr int A_FLOATS = BK * AP, B_FLOATS = BK * BP;
// a stage: an A slab per group and a B slab per group
constexpr int STAGE_FLOATS = 2 * (A_FLOATS + B_FLOATS);
constexpr int HEAD_FLOATS = 16;  // the scan's eight float64 warp totals
constexpr int PASS_THREADS = 256;
constexpr int MIN_BLOCKS = 2;   // tile blocks an SM: 128 registers a thread

// acc[i][j] += sum_k as[k][row i] * bs[k][col j] over one slab; ra / cb
// are the thread's first row / column
__device__ __forceinline__ void slab_fma(const float* __restrict__ as,
                                         const float* __restrict__ bs,
                                         float (&acc)[8][8], int ra, int cb) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * AP + ra);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * AP + ra + 16);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * BP + cb);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * BP + cb + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the thread's group, and its rows and columns in the group's tile
__device__ __forceinline__ int group() { return threadIdx.x / GT; }
__device__ __forceinline__ int group_warp() { return (threadIdx.x % GT) >> 5; }
__device__ __forceinline__ int tile_row(int i) {
  return group_warp() * 32 + (i >> 2) * 16 + ((threadIdx.x & 31) >> 3) * 4
      + (i & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j >> 2) * 32 + (threadIdx.x & 7) * 4 + (j & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4-byte async copy; ok = false zero-fills (src is then any valid address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}
// 16-byte async copy of `bytes` (0..16) bytes, the rest zero-filled
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Slabs are staged k-major, slab[kk * PITCH + r], by all T threads, from
// operands contiguous along r in memory (B and C enter (g) and (c)'s state
// term transposed, (N, S)): VEC copies a 16-byte run of 4 r a thread
// (zero-filled past rn), else one float.  A thread's copies are visible to
// it once they land, before any barrier, so map_rows transforms exactly the
// elements its thread copied.

// slab[kk][r] <- src[kk * ld + r] for kk < kn and r0 <= r < rn (VEC: the
// 16-byte runs that reach r0), else zero
template <int ROWS, int PITCH, bool VEC>
__device__ __forceinline__ void copy_rows(float* slab, const float* src,
                                          int ld, int kn, int rn,
                                          int r0 = 0) {
  if (VEC) {
    constexpr int C4 = ROWS / 4;
#pragma unroll
    for (int it = 0; it < BK * C4 / T; ++it) {
      const int e = threadIdx.x + it * T;
      const int kk = e / C4, r = (e % C4) * 4;
      const int n = kk < kn && r + 3 >= r0 ? 4 * max(0, min(4, rn - r)) : 0;
      cp16(slab + kk * PITCH + r, n ? src + kk * ld + r : src, n);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < BK * ROWS / T; ++it) {
      const int e = threadIdx.x + it * T;
      const int kk = e / ROWS, r = e % ROWS;
      const bool ok = kk < kn && r < rn && r >= r0;
      cp4(slab + kk * PITCH + r, ok ? src + kk * ld + r : src, ok);
    }
  }
}

// On the elements this thread's copy_rows staged in `slab`:
// out[kk][r] <- f(kk, r, slab[kk][r]) (out may be slab itself)
template <int ROWS, int PITCH, bool VEC, typename F>
__device__ __forceinline__ void map_rows(const float* slab, float* out,
                                         F f) {
  if (VEC) {
    constexpr int C4 = ROWS / 4;
#pragma unroll
    for (int it = 0; it < BK * C4 / T; ++it) {
      const int e = threadIdx.x + it * T;
      const int kk = e / C4, r = (e % C4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(slab + kk * PITCH + r);
      *reinterpret_cast<float4*>(out + kk * PITCH + r) = make_float4(
          f(kk, r, v.x), f(kk, r + 1, v.y), f(kk, r + 2, v.z),
          f(kk, r + 3, v.w));
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < BK * ROWS / T; ++it) {
      const int e = threadIdx.x + it * T;
      const int kk = e / ROWS, r = e % ROWS;
      out[kk * PITCH + r] = f(kk, r, slab[kk * PITCH + r]);
    }
  }
}

// out[row][col] = acc for the thread's rows (row < rn) and columns (col <
// cn) of a tile at out; VEC stores 16-byte runs (cn, ld multiples of 4)
template <bool VEC>
__device__ __forceinline__ void store_tile(float* out, long long ld, int rn,
                                           int cn, const float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i);
    if (r >= rn) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const int c = tile_col(j);
      float* p = out + r * ld + c;
      if (VEC) {
        if (c < cn)
          *reinterpret_cast<float4*>(p) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < cn) p[e] = acc[i][j + e];
      }
    }
  }
}

// cum[i] = da[0] + ... + da[i] for i < Q, summed in float64 in a fixed
// order and rounded once; wsum holds T/32 doubles.  Ends synchronised.
__device__ void chunk_cumsum(const float* __restrict__ da, long long stride,
                             int Q, float* cum, double* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (Q + T - 1) / T;
  const int lo = min(Q, tid * per), hi = min(Q, lo + per);
  double s = 0.0;
  for (int i = lo; i < hi; ++i) s += (double)da[i * stride];
  double v = s;   // inclusive scan of the runs' totals within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  double run = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) run = 0.0;
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  double off = 0.0;
  for (int w = 0; w < warp; ++w) off += wsum[w];
  run += off;
  for (int i = lo; i < hi; ++i) {
    run += (double)da[i * stride];
    cum[i] = (float)run;
  }
  __syncthreads();
}

// A stage holds an A slab and a B slab per group: A_g at g * A_FLOATS, B_g
// at 2 * A_FLOATS + g * B_FLOATS.  Offsets, not an array of pointers, so
// that the compiler keeps them shared-memory addresses (LDS, not generic
// loads).
__device__ __forceinline__ float* slab_a(float* stage, int g) {
  return stage + g * A_FLOATS;
}
__device__ __forceinline__ float* slab_b(float* stage, int g) {
  return stage + 2 * A_FLOATS + g * B_FLOATS;
}

// The K loop of a tile: slabs 0 .. ns-1 through a cp.async ring of STAGES
// slabs.  load(t, stage) starts slab t's copies; for each slab the loop
// waits for it, lets prepare(t, stage) transform the thread's own landed
// elements, starts slab t + STAGES-1 and, where compute(t), multiplies
// group g's A slab (group 0's when shared_a) by its B slab.
template <typename Load, typename Prepare, typename Compute>
__device__ __forceinline__ void tile_loop(float* stages, int ns,
                                          bool shared_a, float (&acc)[8][8],
                                          Load load, Prepare prepare,
                                          Compute compute) {
  const int g = group(), lane = threadIdx.x & 31;
  const int ra = group_warp() * 32 + (lane >> 3) * 4;
  const int cb = (lane & 7) * 4;
  const int a_off = (shared_a ? 0 : g) * A_FLOATS;
  const int b_off = 2 * A_FLOATS + g * B_FLOATS;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ns) load(t, stages + t * STAGE_FLOATS);
    cp_commit();
  }
  for (int t = 0; t < ns; ++t) {
    float* st = stages + (t % STAGES) * STAGE_FLOATS;
    cp_wait<STAGES - 2>();   // slab t has landed
    prepare(t, st);
    __syncthreads();   // slab t visible; every warp is done with slab t-1
    if (t + STAGES - 1 < ns)
      load(t + STAGES - 1, stages + ((t + STAGES - 1) % STAGES)
            * STAGE_FLOATS);
    cp_commit();
    if (compute(t)) slab_fma(st + a_off, st + b_off, acc, ra, cb);
  }
  cp_wait<0>();
  __syncthreads();   // the stages are free for the next loop
}

// B and C (B, S, N) -> bct[0] = B^T, bct[1] = C^T, (B, N, S) each: the
// operands of (g) and of (c)'s state term, read contiguous along S
__global__ void __launch_bounds__(256) transpose_kernel(
    const float* __restrict__ bm, const float* __restrict__ cm,
    float* __restrict__ bct, int B, int S, int N, long long sbb, int sbs,
    long long scb, int scs) {
  __shared__ float tile[32][33];
  const int which = blockIdx.z & 1, b = blockIdx.z >> 1;
  const float* src = which ? cm + b * scb : bm + b * sbb;
  const int ld = which ? scs : sbs;
  float* dst = bct + ((long long)which * B + b) * N * S;
  const int s0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int si = s0 + r, n = n0 + tx;
    tile[r][tx] = si < S && n < N ? src[(long long)si * ld + n] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int n = n0 + r, si = s0 + tx;
    if (n < N && si < S) dst[(long long)n * S + si] = tile[tx][r];
  }
}

// Pass (g): gt[b, c][j][i] = B_j . C_i over the tiles holding some i >= j;
// a block: 128 j by 64 i, the two groups each summing half of every 2 BK
// of N, added in a fixed order at the end
template <bool VEC>
__global__ void __launch_bounds__(T, MIN_BLOCKS) gram_kernel(
    const float* __restrict__ bct, float* __restrict__ gt, int B, int S,
    int Q, int N, int nc) {
  extern __shared__ __align__(16) float sm_gram[];
  const int bc = blockIdx.x, b = bc / nc, c = bc % nc;
  const int j0 = blockIdx.y * RT, i0 = blockIdx.z * CT;
  if (i0 + CT - 1 < j0) return;   // all i < j: never read
  const float* bt = bct + (long long)b * N * S + (long long)c * Q;
  const float* ct = bt + (long long)B * N * S;
  const int ns = (N + 2 * BK - 1) / (2 * BK);
  auto load = [&](int t, float* st) {
    for (int h = 0; h < 2; ++h) {
      const long long n0 = (long long)(2 * t + h) * BK;
      copy_rows<RT, AP, VEC>(slab_a(st, h), bt + n0 * S + j0, S, N - n0,
                             Q - j0);
      copy_rows<CT, BP, VEC>(slab_b(st, h), ct + n0 * S + i0, S, N - n0,
                             Q - i0);
    }
  };
  float acc[8][8] = {};
  tile_loop(sm_gram, ns, false, acc, load, [](int, float*) {},
           [&](int) { return j0 + group_warp() * 32 < Q; });
  // group 1's partial sums through shared memory, then group 0 stores
  float* part = sm_gram;   // (RT, CT)
  if (group() == 1)
    store_tile<true>(part, CT, RT, CT, acc);
  __syncthreads();
  if (group() == 1) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j] += part[tile_row(i) * CT + tile_col(j)];
  store_tile<VEC>(gt + ((long long)bc * Q + j0) * Q + i0, Q, Q - j0, Q - i0,
                  acc);
}

// Pass (a): st[b, h, c] (N, hd) = sum_j B_j^T (x_j dt_j tail_j), tail_j =
// exp(cum_last - cum_j); cl[b, h, c] = cum_last.  A block: two heads
// (a group each) of one (batch, chunk), sharing the B slabs.
template <bool VEC>
__global__ void __launch_bounds__(T, MIN_BLOCKS) state_kernel(
    const float* __restrict__ x, const float* __restrict__ bm,
    const float* __restrict__ da, const float* __restrict__ dt,
    float* __restrict__ st, float* __restrict__ cl, int H, int HD, int N,
    int Q, int nc, long long sxb, int sxs, long long sxh, long long sbb,
    int sbs, long long sdab, long long sdas, long long sdah, long long sdtb,
    long long sdts, long long sdth) {
  extern __shared__ __align__(16) float sm_state[];
  const int z = blockIdx.x, nt = blockIdx.y, dtile = blockIdx.z;
  double* wsum = reinterpret_cast<double*>(sm_state);
  float* stages = sm_state + HEAD_FLOATS;
  float* w = stages + STAGES * STAGE_FLOATS;   // (2, Q): dt_j tail_j
  float* cum = w + 2 * Q;                      // (Q) scratch
  const int hp = (H + 1) / 2;
  const int pair = z % hp, bc = z / hp, c = bc % nc, b = bc / nc;
  const int n0 = nt * RT, d0 = dtile * CT;
  const long long t0 = (long long)c * Q;
  int hs[2];   // a missing second head repeats the first
  for (int g = 0; g < 2; ++g) hs[g] = min(2 * pair + g, H - 1);
  const float* bb = bm + b * sbb + t0 * sbs + n0;
  const float* xb0 = x + b * sxb + hs[0] * sxh + t0 * sxs + d0;
  const float* xb1 = x + b * sxb + hs[1] * sxh + t0 * sxs + d0;
  const int ns = (Q + BK - 1) / BK;
  auto load = [&](int t, float* s) {
    const long long j0 = (long long)t * BK;
    copy_rows<RT, AP, VEC>(slab_a(s, 0), bb + j0 * sbs, sbs, Q - j0, N - n0);
    copy_rows<CT, BP, VEC>(slab_b(s, 0), xb0 + j0 * sxs, sxs, Q - j0,
                           HD - d0);
    copy_rows<CT, BP, VEC>(slab_b(s, 1), xb1 + j0 * sxs, sxs, Q - j0,
                           HD - d0);
  };
  for (int g = 0; g < 2; ++g) {
    chunk_cumsum(da + b * sdab + hs[g] * sdah + t0 * sdas, sdas, Q, cum,
                 wsum);
    const float last = cum[Q - 1];
    const float* dtb = dt + b * sdtb + hs[g] * sdth + t0 * sdts;
    for (int j = threadIdx.x; j < Q; j += T)
      w[g * Q + j] = dtb[j * sdts] * expf(last - cum[j]);
    if (nt == 0 && dtile == 0 && threadIdx.x == 0)
      cl[((long long)b * H + hs[g]) * nc + c] = last;
    __syncthreads();
  }
  const int g = group();
  float acc[8][8] = {};
  tile_loop(
      stages, ns, true, acc, load,
      [&](int t, float* s) {
        const int j0 = t * BK;
        for (int h = 0; h < 2; ++h)
          map_rows<CT, BP, VEC>(slab_b(s, h), slab_b(s, h), [&](int kk, int, float v) {
            return j0 + kk < Q ? v * w[h * Q + j0 + kk] : 0.f;
          });
      },
      [&](int) { return n0 + group_warp() * 32 < N; });
  if (g == 1 && hs[1] == hs[0]) return;
  store_tile<VEC>(st + (((long long)b * H + hs[g]) * nc + c) * N * HD
                      + (long long)n0 * HD + d0,
                  HD, N - n0, HD - d0, acc);
}

// Pass (b): per (b, h), in chunk order, slot c (c > 0) <- the state before
// chunk c and S <- exp(cum_last_c) S + dS_c; one thread an (n, d) entry,
// eight chunks' loads in flight at once
__global__ void __launch_bounds__(PASS_THREADS) pass_kernel(
    float* __restrict__ st, const float* __restrict__ cl, int nc,
    long long nhd) {
  const long long e = (long long)blockIdx.y * PASS_THREADS + threadIdx.x;
  if (e >= nhd) return;
  float* p = st + (long long)blockIdx.x * nc * nhd + e;
  const float* l = cl + (long long)blockIdx.x * nc;
  float s = 0.f;   // slot 0 keeps dS_0: (c) reads no state for chunk 0
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) v[k] = p[(c0 + k) * nhd];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (c0 + k < nc) {
        if (c0 + k > 0) p[(c0 + k) * nhd] = s;
        s = s * expf(l[c0 + k]) + v[k];
      }
  }
}

// Pass (c): y rows i0.. of chunk c for two heads (a group each): the
// carried state's term (slabs over N, the C slabs shared), then the
// intra-chunk term (slabs over j <= the tile's last row; C B^T staged once
// and decayed per head)
template <bool VEC>
__global__ void __launch_bounds__(T, MIN_BLOCKS) chunk_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ ctr,
    const float* __restrict__ da, const float* __restrict__ dt,
    const float* __restrict__ gt, const float* __restrict__ st,
    float* __restrict__ y, int S, int H, int HD, int N, int Q, int nc,
    long long sxb, int sxs, long long sxh, long long sdab, long long sdas,
    long long sdah, long long sdtb, long long sdts, long long sdth) {
  extern __shared__ __align__(16) float sm_scan[];
  double* wsum = reinterpret_cast<double*>(sm_scan);
  float* stages = sm_scan + HEAD_FLOATS;
  float* cum = stages + STAGES * STAGE_FLOATS;   // (2, Q)
  float* dts = cum + 2 * Q;                      // (2, Q)
  const int hp = (H + 1) / 2;
  const int z = blockIdx.x, pair = z % hp, bc = z / hp, c = bc % nc,
            b = bc / nc;
  // the last row tiles, which hold the most of the causal triangle, first
  const int i0 = (gridDim.y - 1 - blockIdx.y) * RT, d0 = blockIdx.z * CT;
  const long long t0 = (long long)c * Q;
  int hs[2];   // a missing second head repeats the first
  for (int g = 0; g < 2; ++g) hs[g] = min(2 * pair + g, H - 1);
  const int g = group();
  const int rmin = i0 + group_warp() * 32;   // the warp's rows
  const bool live = rmin < Q;
  // the carried state: zero before the first chunk
  const int ns = c > 0 ? (N + BK - 1) / BK : 0;
  const int ni = (min(Q, i0 + RT) + BK - 1) / BK;
  const long long st0 = ((long long)b * H + hs[0]) * nc + c;
  const long long st1 = ((long long)b * H + hs[1]) * nc + c;
  const float* sp0 = st + st0 * N * HD + d0;
  const float* sp1 = st + st1 * N * HD + d0;
  const float* cb = ctr + (long long)b * N * S + t0 + i0;   // C^T rows
  const float* gb = gt + (long long)bc * Q * Q + i0;
  const float* xb0 = x + b * sxb + hs[0] * sxh + t0 * sxs + d0;
  const float* xb1 = x + b * sxb + hs[1] * sxh + t0 * sxs + d0;
  auto load_state = [&](int t, float* s) {
    const long long n0 = (long long)t * BK;
    copy_rows<RT, AP, VEC>(slab_a(s, 0), cb + n0 * S, S, N - n0, Q - i0);
    copy_rows<CT, BP, VEC>(slab_b(s, 0), sp0 + n0 * HD, HD, N - n0,
                           HD - d0);
    copy_rows<CT, BP, VEC>(slab_b(s, 1), sp1 + n0 * HD, HD, N - n0,
                           HD - d0);
  };
  auto load_intra = [&](int t, float* s) {
    const long long j0 = (long long)t * BK;
    // rows i < j0 of the slab are zero (above the diagonal): not read
    copy_rows<RT, AP, VEC>(slab_a(s, 0), gb + j0 * Q, Q, Q - j0, Q - i0,
                           j0 - i0);
    copy_rows<CT, BP, VEC>(slab_b(s, 0), xb0 + j0 * sxs, sxs, Q - j0,
                           HD - d0);
    copy_rows<CT, BP, VEC>(slab_b(s, 1), xb1 + j0 * sxs, sxs, Q - j0,
                           HD - d0);
  };
  for (int h = 0; h < 2; ++h) {
    chunk_cumsum(da + b * sdab + hs[h] * sdah + t0 * sdas, sdas, Q,
                 cum + h * Q, wsum);
    const float* dtb = dt + b * sdtb + hs[h] * sdth + t0 * sdts;
    for (int j = threadIdx.x; j < Q; j += T) dts[h * Q + j] = dtb[j * sdts];
  }
  __syncthreads();
  float acc[8][8] = {};
  if (ns > 0) {
    tile_loop(stages, ns, true, acc, load_state, [](int, float*) {},
             [&](int) { return live; });
    // the state term's rows decay by exp(cum_i)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = i0 + tile_row(i);
      const float e = r < Q ? expf(cum[g * Q + r]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= e;
    }
  }
  tile_loop(
      stages, ni, false, acc, load_intra,
      [&](int t, float* s) {
        const int j0 = t * BK;
        // (C B^T) o L per head: L_ij = exp(cum_i - cum_j), j <= i < Q
        for (int h = 1; h >= 0; --h)   // head 0 last: it overwrites A_0
          map_rows<RT, AP, VEC>(slab_a(s, 0), slab_a(s, h),
                                [&](int kk, int r, float v) {
            const int i = i0 + r, j = j0 + kk;
            return j <= i && i < Q
                ? v * __expf(cum[h * Q + i] - cum[h * Q + j]) : 0.f;
          });
        for (int h = 0; h < 2; ++h)
          map_rows<CT, BP, VEC>(slab_b(s, h), slab_b(s, h),
                                [&](int kk, int, float v) {
            return j0 + kk < Q ? v * dts[h * Q + j0 + kk] : 0.f;
          });
      },
      [&](int t) { return live && t * BK <= rmin + 31; });
  if (g == 1 && hs[1] == hs[0]) return;
  store_tile<VEC>(y + (((long long)b * S + t0 + i0) * H + hs[g]) * HD + d0,
                  (long long)H * HD, Q - i0, HD - d0, acc);
}

// ---------------------------------------------------------------------------
// The serial kernel, for comparison
// ---------------------------------------------------------------------------

constexpr int SERIAL_THREADS = 256;

__global__ void __launch_bounds__(SERIAL_THREADS) serial_kernel(
    const float* __restrict__ x, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ da,
    const float* __restrict__ dt, float* __restrict__ y, int S, int H,
    int HD, int N, int Q, int R, long long sxb, long long sxs,
    long long sxh, long long sbb, long long sbs, long long scb,
    long long scs, long long sdab, long long sdas, long long sdah,
    long long sdtb, long long sdts, long long sdth) {
  extern __shared__ float smem[];
  float* st = smem;                // (N, HD): the state, transposed
  float* ci = st + N * HD;         // (R, N): rows of C
  float* bt = ci + R * N;          // (N, R+1): rows of B, transposed
  float* xj = bt + N * (R + 1);    // (R, HD): x * dt (times the tail decay)
  float* yi = xj + R * HD;         // (R, HD): output rows
  float* mm = yi + R * HD;         // (R, R): (C B^T) * decay block
  float* cum = mm + R * R;         // (Q): cumsum of da over the chunk
  float* dts = cum + Q;            // (Q): dt over the chunk
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* xb = x + b * sxb + h * sxh;
  const float* bb = bm + b * sbb;
  const float* cb = cm + b * scb;
  const float* dab = da + b * sdab + h * sdah;
  const float* dtb = dt + b * sdtb + h * sdth;
  float* yb = y + ((long long)b * S * H + h) * HD;
  const long long ys = (long long)H * HD;
  const int nsub = Q / R;

  for (int i = tid; i < N * HD; i += SERIAL_THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();   // the previous chunk's state update is done
    for (int i = tid; i < Q; i += SERIAL_THREADS) {
      cum[i] = dab[(t0 + i) * sdas];
      dts[i] = dtb[(t0 + i) * sdts];
    }
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int i = 0; i < Q; ++i) {
        c += cum[i];
        cum[i] = c;
      }
    }
    __syncthreads();
    const float c_last = cum[Q - 1];

    for (int I = 0; I < nsub; ++I) {
      const int i0 = I * R;
      for (int idx = tid; idx < R * N; idx += SERIAL_THREADS) {
        const int i = idx / N, n = idx % N;
        ci[idx] = cb[(t0 + i0 + i) * scs + n];
      }
      __syncthreads();
      // carried-state term, from the state before this chunk
      for (int idx = tid; idx < R * HD; idx += SERIAL_THREADS) {
        const int i = idx / HD, d = idx % HD;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc = fmaf(ci[i * N + n], st[n * HD + d],
                                               acc);
        yi[idx] = acc * expf(cum[i0 + i]);
      }
      // intra-chunk term, row blocks J <= I
      for (int J = 0; J <= I; ++J) {
        const int j0 = J * R;
        __syncthreads();   // bt, xj and mm are free
        for (int idx = tid; idx < R * N; idx += SERIAL_THREADS) {
          const int j = idx / N, n = idx % N;
          bt[n * (R + 1) + j] = bb[(t0 + j0 + j) * sbs + n];
        }
        for (int idx = tid; idx < R * HD; idx += SERIAL_THREADS) {
          const int j = idx / HD, d = idx % HD;
          xj[idx] = xb[(t0 + j0 + j) * sxs + d] * dts[j0 + j];
        }
        __syncthreads();
        for (int idx = tid; idx < R * R; idx += SERIAL_THREADS) {
          const int i = idx / R, j = idx % R;
          float val = 0.f;
          if (j0 + j <= i0 + i) {
            float s = 0.f;
            for (int n = 0; n < N; ++n)
              s = fmaf(ci[i * N + n], bt[n * (R + 1) + j], s);
            val = s * expf(cum[i0 + i] - cum[j0 + j]);
          }
          mm[idx] = val;
        }
        __syncthreads();
        for (int idx = tid; idx < R * HD; idx += SERIAL_THREADS) {
          const int i = idx / HD, d = idx % HD;
          float acc = 0.f;
          for (int j = 0; j < R; ++j) acc = fmaf(mm[i * R + j],
                                                 xj[j * HD + d], acc);
          yi[idx] += acc;
        }
      }
      for (int idx = tid; idx < R * HD; idx += SERIAL_THREADS) {
        const int i = idx / HD, d = idx % HD;
        yb[(t0 + i0 + i) * ys + d] = yi[idx];
      }
      __syncthreads();   // ci and yi are reused by the next row block
    }

    // state update; each thread owns the same (n, d) entries throughout
    const float chunk_decay = expf(c_last);
    for (int idx = tid; idx < N * HD; idx += SERIAL_THREADS) st[idx] *= chunk_decay;
    for (int J = 0; J < nsub; ++J) {
      const int j0 = J * R;
      __syncthreads();
      for (int idx = tid; idx < R * N; idx += SERIAL_THREADS) {
        const int j = idx / N, n = idx % N;
        bt[n * (R + 1) + j] = bb[(t0 + j0 + j) * sbs + n];
      }
      for (int idx = tid; idx < R * HD; idx += SERIAL_THREADS) {
        const int j = idx / HD, d = idx % HD;
        xj[idx] = xb[(t0 + j0 + j) * sxs + d] * dts[j0 + j]
                  * expf(c_last - cum[j0 + j]);
      }
      __syncthreads();
      for (int idx = tid; idx < N * HD; idx += SERIAL_THREADS) {
        const int n = idx / HD, d = idx % HD;
        float acc = 0.f;
        for (int j = 0; j < R; ++j) acc = fmaf(xj[j * HD + d],
                                               bt[n * (R + 1) + j], acc);
        st[idx] += acc;
      }
    }
  }
}

// Let a kernel take `bytes` of dynamic shared memory, with the carveout at
// its most shared memory, so that MIN_BLOCKS blocks fit on an SM whatever
// split the runtime would pick by default.
template <typename K>
cudaError_t use_smem(K kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Dynamic shared memory: the scan's totals, the stages and, for passes (a)
// and (c), four (Q) vectors.
int pass_smem(int Q) {
  return 4 * (HEAD_FLOATS + STAGES * STAGE_FLOATS + 4 * Q);
}

}  // namespace

// x (B, S, H, HD), bm / cm (B, S, N), da / dt (B, S, H) float32; y (B, S,
// H, HD) contiguous.  Scratch: gt (B, S/Q, Q, Q), st (B, H, S/Q, N, HD), cl
// (B, H, S/Q), bct (2, B, N, S) float32.  mode 0 runs passes t, g, a, b, c;
// 1-4 one part alone (t and g, a, b, c; for timing: each reads what the
// earlier ones left); 5 the serial kernel (scratch unused).
extern "C" int ssd_scan_launch(
    const void* x, const void* bm, const void* cm, const void* da,
    const void* dt, void* y, void* gt, void* st, void* cl, void* bct, int B,
    int S, int H, int HD, int N, int Q, long long sxb, long long sxs,
    long long sxh, long long sbb, long long sbs, long long scb,
    long long scs, long long sdab, long long sdas, long long sdah,
    long long sdtb, long long sdts, long long sdth, int mode,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Q < 1 || S % Q) return (int)cudaErrorInvalidValue;
  const int nc = S / Q;
  const float* xf = (const float*)x;
  const float* bf = (const float*)bm;
  const float* cf = (const float*)cm;
  const float* daf = (const float*)da;
  const float* dtf = (const float*)dt;
  if (mode == 5) {
    const int R = Q < 64 ? Q : 64;
    const long long smem = 4LL * ((long long)N * HD + R * N + N * (R + 1)
                                  + 2 * R * HD + R * R + 2 * Q);
    if (Q % R || smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        serial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    serial_kernel<<<dim3(H, B), SERIAL_THREADS, (int)smem, s>>>(
        xf, bf, cf, daf, dtf, (float*)y, S, H, HD, N, Q, R, sxb, sxs, sxh,
        sbb, sbs, scb, scs, sdab, sdas, sdah, sdtb, sdts, sdth);
    return (int)cudaGetLastError();
  }
  if (mode < 0 || mode > 4) return (int)cudaErrorInvalidValue;
  // the strides along the sequence enter 32-bit products
  if (sxs > INT_MAX || sbs > INT_MAX || scs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const unsigned bc = (unsigned)B * nc, bch = bc * (unsigned)((H + 1) / 2);
  // 16-byte copies where every operand row is 16-byte aligned
  const bool vec = Q % 4 == 0 && HD % 4 == 0 && N % 4 == 0 && sxb % 4 == 0
      && sxs % 4 == 0 && sxh % 4 == 0 && sbb % 4 == 0 && sbs % 4 == 0
      && (uintptr_t)x % 16 == 0 && (uintptr_t)bm % 16 == 0
      && (uintptr_t)gt % 16 == 0 && (uintptr_t)st % 16 == 0
      && (uintptr_t)bct % 16 == 0;
  const int smem = pass_smem(Q);
  if (mode == 0 || mode == 1) {   // B^T, C^T, then (g)
    const unsigned gx = (unsigned)((S + 31) / 32), gy = (unsigned)((N + 31) / 32);
    if (N > 0) {
      transpose_kernel<<<dim3(gx, gy, 2 * B), 256, 0, s>>>(
          bf, cf, (float*)bct, B, S, N, sbb, (int)sbs, scb, (int)scs);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    auto kern = vec ? gram_kernel<true> : gram_kernel<false>;
    cudaError_t e = use_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(bc, (Q + RT - 1) / RT, (Q + CT - 1) / CT), T, smem, s>>>(
        (const float*)bct, (float*)gt, B, S, Q, N, nc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // N = 0: no state, and C B^T = 0 from (g)
  if ((mode == 0 || mode == 2) && N > 0) {
    auto kern = vec ? state_kernel<true> : state_kernel<false>;
    cudaError_t e = use_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(bch, (N + RT - 1) / RT, (HD + CT - 1) / CT), T, smem, s>>>(
        xf, bf, daf, dtf, (float*)st, (float*)cl, H, HD, N, Q, nc, sxb,
        (int)sxs, sxh, sbb, (int)sbs, sdab, sdas, sdah, sdtb, sdts, sdth);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if ((mode == 0 || mode == 3) && N > 0) {
    const long long nhd = (long long)N * HD;
    pass_kernel<<<dim3((unsigned)B * H,
                       (unsigned)((nhd + PASS_THREADS - 1) / PASS_THREADS)),
                  PASS_THREADS, 0, s>>>((float*)st, (const float*)cl, nc,
                                        nhd);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (mode == 0 || mode == 4) {
    auto kern = vec ? chunk_scan_kernel<true> : chunk_scan_kernel<false>;
    cudaError_t e = use_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<dim3(bch, (Q + RT - 1) / RT, (HD + CT - 1) / CT), T,
                        smem, s>>>(
        xf, (const float*)bct + (long long)B * N * S, daf, dtf,
        (const float*)gt, (const float*)st, (float*)y, S, H, HD, N, Q, nc,
        sxb, (int)sxs, sxh, sdab, sdas, sdah, sdtb, sdts, sdth);
    return (int)cudaGetLastError();
  }
  return (int)cudaSuccess;
}
