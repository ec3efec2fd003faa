// Public-weight grouped (depthwise) product for every held share slot
// (Hopper, sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/bin_rss_matmul.py::_make_grouped_public_kernel
// (pallas_call in _grouped_public_call).  Per share slot s and channel c:
//
//     z_s[c] = x_s[c] · W[c]      (mod 2^32)
//
// with x_s[c] an (M, K) patch matrix (K = kh·kw: 9 or 25 in the nets) and
// W[c] the public (K, N) slab (N = 1: depthwise multiplier 1).  The TPU
// kernel decomposed the words into int8 limbs (adaptive L for the public
// side) for its MXU; here the words are multiplied with 32-bit IMADs and
// accumulated in uint32_t (wrap = ring arithmetic).  Tensor-core tiles
// would be mostly padding at K <= 25, N = 1.
//
// What bounds it: bytes.  Every x word is read once and used for one
// multiply-add, so the floor is the x read plus the z write (and the small
// public slab) over 3.35 TB/s.  At the nets' shapes a launch moves 3–60
// MB, so the fixed cost of a launch (about 5 µs between two CUDA events on
// the H100, whatever the kernel) is a large share of each one; what the
// design can change is the bytes in flight, the load width and the work
// done before the first load (slot_rows_kernel):
//
//  * One thread owns one (m, channel group) row for ALL S slots: the
//    public slab is the same for every slot, so its words are read from
//    shared memory once a row and applied to each slot's row.  The next
//    slot's row is loaded while this one is multiplied, and after the
//    last slot the thread's next grid-stride row: every thread always has
//    a row of loads in flight.
//  * All K loads of a row are issued before its first multiply-add: the
//    kernel is templated on K = 9 and 25 (the nets' 3 x 3 and 5 x 5
//    windows); slot_rows_any_kernel takes any other K in register chunks.
//  * x is read through its strides, so the secure path hands over the
//    im2col (S, M, K, C) buffer as an (S, C, M, K) view and no transpose is
//    materialised (the TPU path's _fold_grouped).  In that channel-
//    contiguous layout a thread takes 4 neighbouring channels with 16-byte
//    loads where C % 4 == 0 and the base and strides are 16-byte
//    multiples, and writes each slot's 4 z words with one 16-byte store
//    when N = 1; otherwise one channel with 4-byte loads (CifarNet2's
//    C = 3, a misaligned view, the (S, C, M, K) layout).
//  * The slab is staged as [N][K][C], channel fastest (4 channels' weights
//    are one 16-byte shared load), by asynchronous copies started after the
//    thread's first row loads are issued.  Any C: a block stages only its
//    own range of channels (blockIdx.y), at most 48 KB of words, so no
//    slab is too large.
//  * Blocks are capped at those resident at once, and stride over the
//    rows: each stages its slab once.
//
// The row helpers are grouped_rows.cuh, shared with B2
// (grouped_rss_matmul.cu).
//
// per_slot_kernel is the first design (kept for chip_smoke.py's same-call
// comparison): the slot on blockIdx.y, each thread one (channel, m) row of
// one slot with a runtime K loop of dependent 4-byte loads, every block
// staging the whole slab (so C·K·N <= 12,288 words) before any x load.

#include <cstdint>
#include <cuda_runtime.h>

#include "grouped_rows.cuh"

namespace {

using namespace grouped_rows;

constexpr int THREADS = 128;
constexpr int K_CHUNK = 16;          // the any-K kernel's register chunk
constexpr int SLAB_WORDS = (int)(SMEM_DEFAULT / sizeof(uint32_t));
constexpr int OLD_THREADS = 256;
constexpr int OLD_MAX_BLOCKS = 132 * 16;

struct Args {
  const uint32_t* x;
  const uint32_t* w;
  uint32_t* z;
  int S, C, K, N;
  int ct;                            // channels a block stages (its range)
  long long M;
  long long sxs, sxc, sxm, sxk;      // x (S, C, M, K) element strides
  long long szs, szc, szm, szn;      // z (S, C, M, N) element strides
  bool c_fast;                       // channels are the contiguous axis
  bool vec_z;                        // V-word z stores
};

// the block's channels [c0, c0 + cn) of the (C, K, N) slab as [N][K][cn],
// by 4-byte asynchronous copies all in flight at once
__device__ __forceinline__ void stage_slab(const Args& a, int c0, int cn,
                                           uint32_t* wsh) {
  const int K = a.K, N = a.N, kn = K * N, total = cn * kn;
  const uint32_t* src = a.w + (long long)c0 * kn;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i / kn, e = i - c * kn;
    const int k = N == 1 ? e : e / N, n = e - k * N;
    cp_async4(wsh + (n * K + k) * cn + c, src + i);
  }
  cp_async_wait_all();
}

// K = KT: one thread a (m, V channels) row of every slot, all KT loads of
// a slot's row issued first; with PIPE the next slot's row (after the last
// slot, the next grid-stride row's first) is in flight while one is
// multiplied.  The first row's loads go out before the slab is staged.
template <int KT, int V, bool PIPE>
__global__ void __launch_bounds__(THREADS)
slot_rows_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t wsh[];
  const int S = a.S, N = a.N;
  const int c0 = blockIdx.y * a.ct, cn = min(a.ct, a.C - c0);
  const int groups = cn / V, kc = KT * cn;
  const long long rows = a.M * groups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t xv[KT][V], xn[PIPE ? KT : 1][V];
  auto load = [&](auto& dst, int c, long long m, int s) {
    const uint32_t* xs = a.x + (c0 + c) * a.sxc + m * a.sxm + s * a.sxs;
#pragma unroll
    for (int k = 0; k < KT; ++k) load_global<V>(dst[k], xs + k * a.sxk);
  };
  int c = 0;
  long long m = 0;
  if (t < rows) {
    locate<V>(t, groups, a.M, a.c_fast, c, m);
    load(xv, c, m, 0);
  }
  stage_slab(a, c0, cn, wsh);
  __syncthreads();
  for (; t < rows; t += stride) {
    const bool more = t + stride < rows;
    int c2 = 0;
    long long m2 = 0;
    if (more) locate<V>(t + stride, groups, a.M, a.c_fast, c2, m2);
    uint32_t* zr = a.z + (c0 + c) * a.szc + m * a.szm;
    for (int s = 0; s < S; ++s) {
      if constexpr (PIPE) {
        if (s + 1 < S) load(xn, c, m, s + 1);
        else if (more) load(xn, c2, m2, 0);
      }
      for (int n = 0; n < N; ++n) {
        const uint32_t* wn = wsh + n * kc + c;
        uint32_t acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0u;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          uint32_t f[V];
          load_shared<V>(f, wn + k * cn);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += xv[k][v] * f[v];
        }
        store_row<V>(zr + s * a.szs + n * a.szn, acc, a.vec_z, a.szc);
      }
      if constexpr (PIPE) {
#pragma unroll
        for (int k = 0; k < KT; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v) xv[k][v] = xn[k][v];
      } else {
        if (s + 1 < S) load(xv, c, m, s + 1);
        else if (more) load(xv, c2, m2, 0);
      }
    }
    c = c2;
    m = m2;
  }
}

// Any K: the same rows, K in register chunks of K_CHUNK words, the loads of
// a chunk issued before its first multiply-add (a row is read again for
// each n > 0).
template <int V>
__global__ void __launch_bounds__(THREADS)
slot_rows_any_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t wsh[];
  const int S = a.S, K = a.K, N = a.N;
  const int c0 = blockIdx.y * a.ct, cn = min(a.ct, a.C - c0);
  const int groups = cn / V, kc = K * cn;
  stage_slab(a, c0, cn, wsh);
  __syncthreads();
  const long long rows = a.M * groups;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < rows; t += (long long)gridDim.x * blockDim.x) {
    int c;
    long long m;
    locate<V>(t, groups, a.M, a.c_fast, c, m);
    const uint32_t* xr = a.x + (c0 + c) * a.sxc + m * a.sxm;
    uint32_t* zr = a.z + (c0 + c) * a.szc + m * a.szm;
    for (int s = 0; s < S; ++s) {
      for (int n = 0; n < N; ++n) {
        const uint32_t* wn = wsh + n * kc + c;
        uint32_t acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0u;
        for (int k0 = 0; k0 < K; k0 += K_CHUNK) {
          uint32_t xv[K_CHUNK][V];
#pragma unroll
          for (int j = 0; j < K_CHUNK; ++j)
            if (k0 + j < K)
              load_global<V>(xv[j], xr + s * a.sxs + (k0 + j) * a.sxk);
#pragma unroll
          for (int j = 0; j < K_CHUNK; ++j) {
            if (k0 + j >= K) continue;
            uint32_t f[V];
            load_shared<V>(f, wn + (k0 + j) * cn);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] += xv[j][v] * f[v];
          }
        }
        store_row<V>(zr + s * a.szs + n * a.szn, acc, a.vec_z, a.szc);
      }
    }
  }
}

// the 3 x 3 windows with the next row in flight; 5 x 5 too where two rows
// fit the registers (4-byte loads)
template <int V>
int launch_slots(const Args& a, cudaStream_t st) {
  const long long rows = a.M * (a.ct / V);
  const unsigned tiles = (unsigned)((a.C + a.ct - 1) / a.ct);
  const size_t smem = (size_t)a.ct * a.K * a.N * sizeof(uint32_t);
  if (a.K == 9)
    return launch(slot_rows_kernel<9, V, true>, a, rows, THREADS, 0, tiles,
                  smem, st);
  if (a.K == 25)
    return launch(slot_rows_kernel<25, V, V == 1>, a, rows, THREADS, 0,
                  tiles, smem, st);
  return launch(slot_rows_any_kernel<V>, a, rows, THREADS, 0, tiles, smem,
                st);
}

__global__ void __launch_bounds__(OLD_THREADS)
per_slot_kernel(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ w,
                uint32_t* __restrict__ z,
                int C, long long M, int K, int N,
                long long sxs, long long sxc, long long sxm,
                long long sxk, long long szs, long long szc,
                long long szm, long long szn) {
  extern __shared__ uint32_t wsh[];  // the public slab, (C, K, N)
  const int s = blockIdx.y;
  const int ckn = C * K * N;
  for (int e = threadIdx.x; e < ckn; e += blockDim.x) wsh[e] = w[e];
  __syncthreads();

  const bool c_fast = sxc <= sxm;  // channel-contiguous layout
  const long long total = M * C;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    int c;
    long long m;
    if (c_fast) {
      c = (int)(t % C);
      m = t / C;
    } else {
      m = t % M;
      c = (int)(t / M);
    }
    const uint32_t* xo = x + s * sxs + c * sxc + m * sxm;
    const uint32_t* wc = wsh + c * K * N;
    uint32_t* zo = z + s * szs + c * szc + m * szm;
    for (int n = 0; n < N; ++n) {
      uint32_t acc = 0u;
      for (int k = 0; k < K; ++k) acc += xo[k * sxk] * wc[k * N + n];
      zo[n * szn] = acc;
    }
  }
}

}  // namespace

// x: (S, C, M, K) with element strides sx*; w: contiguous (C, K, N);
// z: (S, C, M, N) with element strides sz*.  mode 0: slot_rows_kernel
// (each block stages at most 48 KB of the slab: any C, K·N <= 12,288);
// 1: the first design, per_slot_kernel (4·C·K·N bytes of shared memory,
// within the 48 KB default).
extern "C" int bin_grouped_matmul_launch(
    const void* x, const void* w, void* z, int S, int C, long long M, int K,
    int N, long long sxs, long long sxc, long long sxm, long long sxk,
    long long szs, long long szc, long long szm, long long szn, int mode,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1) {
    const size_t smem = (size_t)C * K * N * sizeof(uint32_t);
    if (smem > SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
    const long long total = M * C;
    long long blocks = (total + OLD_THREADS - 1) / OLD_THREADS;
    if (blocks > OLD_MAX_BLOCKS) blocks = OLD_MAX_BLOCKS;
    per_slot_kernel<<<dim3((unsigned)blocks, (unsigned)S), OLD_THREADS, smem,
                      st>>>(
        (const uint32_t*)x, (const uint32_t*)w, (uint32_t*)z, C, M, K, N, sxs,
        sxc, sxm, sxk, szs, szc, szm, szn);
    return (int)cudaGetLastError();
  }
  if (mode != 0 || K * N > SLAB_WORDS) return (int)cudaErrorInvalidValue;
  Args a{(const uint32_t*)x, (const uint32_t*)w, (uint32_t*)z, S, C, K, N,
         C, M, sxs, sxc, sxm, sxk, szs, szc, szm, szn, sxc <= sxm, false};
  // a block's channel range: the whole slab where it fits 48 KB, else
  // ranges of a multiple of 4 channels (so the 16-byte path holds in each)
  const int fit = SLAB_WORDS / (K * N);
  const int V =
      grouped_rows::vec_x(4, a.c_fast, C, sxs, sxc, sxm, sxk, x) && fit >= 4
          ? 4 : 1;
  if (C > fit) a.ct = fit / V * V;
  a.vec_z = grouped_rows::vec_z(V, N, szs, szc, szm, szn, z);
  return V == 4 ? launch_slots<4>(a, st) : launch_slots<1>(a, st);
}
