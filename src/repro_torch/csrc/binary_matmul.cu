// Binarized products (Hopper, sm_90a): two entry points.
//
// bin_weight_matmul replaces the TPU kernel
// repro/kernels/binary_matmul.py::_bin_matmul_kernel (pallas_call in
// _binary_weight_matmul_jit):  C = A · W mod 2^32, A (M, K) ring words, W
// (K, N) int8 (±1 or {0, 1} in the reference's use).  The TPU kernel split
// A into 4 balanced int8 limbs for 4 int8 MXU dots.  Two routes here, chosen
// by shape in the wrapper (kernels/limbs.py::limb_mma_plan), never as a
// fallback:
//
//  * tensor cores (K > 16): limb_mma.cuh's instantiation <1, 1>.  An int8
//    weight is its own single balanced limb (v_0 = w, sign-extended, is the
//    reference's int8 -> uint32 cast), so x · w ≡ Σ_p 2^{8p} u_p · w over
//    x's four unsigned bytes u_p: four wgmma u8 x s8 a K stage, exact for
//    any int8 weight.  wgmma takes an 8-bit B operand only K-major, so a
//    first pass (weight_t_kernel) writes w as one K-major, 128-padded
//    (Np, Kp) byte plane, zero past K and N: a byte transpose through
//    shared memory in ring_matmul.cu's split-pass tiles.  Split-K by int32
//    atomics where the tiles leave SMs idle (the M = 32 fc layers), into
//    an output the weight pass zeroes (no memset launch).
//  * CUDA cores (K <= 16, where a k32 step would be mostly padding):
//    ring_tile.cuh's IMAD tile loop, each word multiplied by the
//    sign-extended weight in uint32_t (the kernel's first design, which
//    chip_smoke.py also times at every shape beside the other route).
//
// bin_bin_matmul replaces _bb_kernel (pallas_call in binary_binary_matmul):
// the plaintext BNN layer, int8 A (M, K) times int8 W (K, N) into int32,
// on the int8 tensor cores: mma.sync m16n8k32 .s32.s8.s8.s32 with no
// .satfinite, so the int32 sums wrap as the reference's int32 accumulator
// does and the result is exact for any int8 operands.  (wgmma's 64-row
// tiles would waste half of the M = 32 fc layers, hence mma.sync.)
//
//  * Tiles: a block of 4 warps owns a 32 x 64 output tile, each warp 16 x
//    32 (four m16n8 accumulators), and walks K in 128-byte slabs.
//  * Staging: A is K-contiguous, W is N-contiguous.  When K and N are
//    multiples of 16 and the bases 16-byte aligned, both slabs are copied
//    by 16-byte cp.async into a three-stage ring (zero-filled past the
//    edges); each W slab is then transposed in shared memory, 4 x 4 bytes a
//    thread with byte permutes, into K-contiguous columns.  Otherwise
//    (conv1's K = 25, fc2's N = 10, the ragged test shapes) the slabs are
//    gathered byte by byte, masked with zeros, straight into the same
//    layouts.  Both layouts XOR-swizzle their 16-byte chunks by row, so
//    every ldmatrix, and the cp.async path's transposed stores, are free
//    of bank conflicts.  A warp multiplies only the 32-byte K steps that
//    hold data, and a warp whose columns all lie past N none.
//  * Split-K: where the (m, n) tile grid has fewer blocks than the card
//    has SMs (MnistNet4's fc1, 32 x 3136 x 512, has 8), K is split over
//    grid.z and the partial sums are added with int32 atomics into an
//    output zeroed first (cudaMemsetAsync on the same stream).  Integer
//    addition mod 2^32 does not depend on order, so every run is
//    bit-identical.
//
// What bounds them: at the classifier's shapes, bytes (each input read once,
// the output written once, over 3.35 TB/s) or, for the deepest fc layer,
// the int8 operation count the TPU route needs (4 dots a cell for
// bin_weight_matmul, 1 for bin_bin_matmul).  At MnistNet4's shapes
// bin_weight_matmul's two launches (weight pass, product) bound it.

#include "limb_mma.cuh"
#include "ring_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// bin_weight_matmul's weight pass: w (K, N) int8 -> the K-major plane
// ---------------------------------------------------------------------------

constexpr int T_TILE = 64;         // a pass block's tile: 64 k x 64 n
constexpr int T_THREADS = 256;

// wt[n][k] = w[k][n] as (Np, Kp) bytes, zero past K and N; and, for a
// split-K product, z's mn words zeroed (z 16-byte aligned), which saves the
// product a memset launch
__global__ void __launch_bounds__(T_THREADS)
weight_t_kernel(const int8_t* __restrict__ w, uint32_t* __restrict__ wt,
                int K, int N, int Kp, uint32_t* __restrict__ z,
                long long mn) {
  // [n][k]; a 68-byte pitch keeps the 4-byte reads aligned and the byte
  // stores of a warp (32 n, one k) on 32 banks
  __shared__ __align__(4) uint8_t v[T_TILE][T_TILE + 4];
  const int k0 = blockIdx.x * T_TILE, n0 = blockIdx.y * T_TILE;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < T_TILE * T_TILE / T_THREADS; ++j) {
    const int e = tid + j * T_THREADS;
    const int kk = e / T_TILE, nn = e % T_TILE;   // n fastest: coalesced
    const int gk = k0 + kk, gn = n0 + nn;
    v[nn][kk] = (gk < K && gn < N) ? (uint8_t)w[(long long)gk * N + gn]
                                   : (uint8_t)0;
  }
  __syncthreads();
  // each thread: 4 consecutive k of one n -> one 4-byte word
#pragma unroll
  for (int j = 0; j < T_TILE * T_TILE / 4 / T_THREADS; ++j) {
    const int e = tid + j * T_THREADS;
    const int nn = e / (T_TILE / 4), g = e % (T_TILE / 4);
    wt[((long long)(n0 + nn) * Kp + k0 + 4 * g) / 4] =
        *reinterpret_cast<const uint32_t*>(&v[nn][4 * g]);
  }
  if (z != nullptr) {
    const long long threads = (long long)gridDim.x * gridDim.y * T_THREADS;
    const long long id =
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * T_THREADS + tid;
    for (long long i = id; i < mn / 4; i += threads)
      reinterpret_cast<uint4*>(z)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = mn / 4 * 4 + id; i < mn; i += threads) z[i] = 0u;
  }
}

// ---------------------------------------------------------------------------
// bin_bin_matmul: int8 x int8 -> int32 on the tensor cores
// ---------------------------------------------------------------------------

namespace bb {

constexpr int BM = 32;          // output rows of a block
constexpr int BN = 64;          // output cols of a block
constexpr int BK = 128;         // K bytes of a slab (8 chunks of 16)
constexpr int THREADS = 128;    // 4 warps: 2 (m) x 2 (n) of 16 x 32
constexpr int STAGES = 3;       // slabs in flight (aligned path)
constexpr int WPITCH = BN + 16; // raw W slab row, bytes (2-way reads)
constexpr int A_BYTES = BM * BK;
constexpr int WRAW_BYTES = BK * WPITCH;
constexpr int WT_BYTES = BN * BK;
constexpr int SMEM_ALIGNED = STAGES * (A_BYTES + WRAW_BYTES) + WT_BYTES;
constexpr int SMEM_GATHER = A_BYTES + WT_BYTES;

// byte offset of 16-byte chunk `ch` of row `r` in a 128-byte-row tile
__device__ __forceinline__ int a_off(int r, int ch) {
  return r * BK + ((ch ^ (r & 7)) << 4);
}
__device__ __forceinline__ int w_off(int n, int ch) {
  return n * BK + ((ch ^ ((n ^ (n >> 3)) & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a (16x32 s8, row) * b (32x8 s8, col); int32 sums wrap mod 2^32
__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one slab: each warp's 16 x 32 outputs over the slab's first 32 * ksteps
// bytes of K (the rest of a ragged last slab is zeros)
__device__ __forceinline__ void slab_mma(int32_t (&acc)[4][4],
                                         const uint8_t* as,
                                         const uint8_t* wt, int wm, int wn,
                                         int lane, int ksteps) {
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks) {
    if (ks >= ksteps) break;
    uint32_t af[4];
    const int r = wm * 16 + (lane & 15);
    ldsm_x4(af, as + a_off(r, 2 * ks + (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t bf[4];
      const int n = wn * 32 + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldsm_x4(bf, wt + w_off(n, 2 * ks + ((lane >> 3) & 1)));
      mma_s8(acc[2 * jp], af, bf[0], bf[1]);
      mma_s8(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// aligned path: raw W slab [k][n] -> wt [n][k], 4 x 4 bytes a thread
__device__ __forceinline__ void transpose_w(const uint8_t* wraw, uint8_t* wt,
                                            int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int j = 0; j < (BK / 4) * (BN / 4) / THREADS; ++j) {
    const int grp = j * (THREADS / 32) + tid / 32;   // 16 groups of 32
    const int nb = (grp & 1) * 8 + (lane & 7);       // 4 columns from 4nb
    const int kb = (grp >> 1) * 4 + (lane >> 3);     // 4 rows from 4kb
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(
          wraw + (4 * kb + r) * WPITCH + 4 * nb);
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410),
                             __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410),
                             __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(wt + w_off(4 * nb + c, kb >> 2)
                                   + (kb & 3) * 4) = col[c];
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
bin_bin_matmul_kernel(const int8_t* __restrict__ a,
                      const int8_t* __restrict__ w,
                      int32_t* __restrict__ c, long long M, int K, int N,
                      int k_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int n_slabs = (kend - kbeg + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp & 1, wn = warp >> 1;
  // a warp whose 32 columns all lie past N (N = 32 or less) multiplies
  // nothing but still stages and syncs with the block
  const bool live = n0 + wn * 32 < N;

  int32_t acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  if constexpr (ALIGNED) {
    uint8_t* as = smem;                               // STAGES A slabs
    uint8_t* wraw = smem + STAGES * A_BYTES;          // STAGES raw W slabs
    uint8_t* wt = wraw + STAGES * WRAW_BYTES;         // transposed W slab
    auto load_slab = [&](int slab, int stage) {
      const int k0 = kbeg + slab * BK;
#pragma unroll
      for (int j = 0; j < BM * (BK / 16) / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i >> 3, ch = i & 7;
        const long long gm = m0 + r;
        const int gk = k0 + ch * 16;
        const bool ok = gm < M && gk < kend;
        cp_async16(as + stage * A_BYTES + a_off(r, ch),
                   a + (ok ? gm * K + gk : 0), ok);
      }
#pragma unroll
      for (int j = 0; j < BK * (BN / 16) / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i >> 2, ch = i & 3;
        const int gk = k0 + r, gn = n0 + ch * 16;
        const bool ok = gk < kend && gn < N;
        cp_async16(wraw + stage * WRAW_BYTES + r * WPITCH + ch * 16,
                   w + (ok ? (long long)gk * N + gn : 0), ok);
      }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_slabs) load_slab(s, s);
      cp_async_commit();
    }
    for (int t = 0; t < n_slabs; ++t) {
      const int nxt = t + STAGES - 1;
      if (nxt < n_slabs) load_slab(nxt, nxt % STAGES);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();   // slab t has landed
      __syncthreads();
      transpose_w(wraw + (t % STAGES) * WRAW_BYTES, wt, tid);
      __syncthreads();
      if (live)
        slab_mma(acc, as + (t % STAGES) * A_BYTES, wt, wm, wn, lane,
                 (min(BK, kend - kbeg - t * BK) + 31) / 32);
      __syncthreads();   // wt and this stage are rewritten next
    }
  } else {
    uint8_t* as = smem;
    uint8_t* wt = smem + A_BYTES;
    for (int t = 0; t < n_slabs; ++t) {
      const int k0 = kbeg + t * BK;
      // only the k32 steps that hold data are staged and multiplied
      const int ksteps = (min(BK, kend - k0) + 31) / 32;
      const int words = 8 * ksteps;   // 4-byte words of K a row or column
      // A: BM rows, 4 consecutive k of one row a word
      for (int i = tid; i < BM * words; i += THREADS) {
        const int r = i / words, kw = i % words;
        const long long gm = m0 + r;
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + 4 * kw + e;
          if (gm < M && gk < kend)
            word |= (uint32_t)(uint8_t)a[gm * K + gk] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(as + a_off(r, kw >> 2) + (kw & 3) * 4)
            = word;
      }
      // W: BN columns, 4 consecutive k of one column a word
      for (int i = tid; i < BN * words; i += THREADS) {
        const int n = i % BN, kw = i / BN;
        const int gn = n0 + n;
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + 4 * kw + e;
          if (gn < N && gk < kend)
            word |= (uint32_t)(uint8_t)w[(long long)gk * N + gn] << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(wt + w_off(n, kw >> 2) + (kw & 3) * 4)
            = word;
      }
      __syncthreads();
      if (live) slab_mma(acc, as, wt, wm, wn, lane, ksteps);
      __syncthreads();
    }
  }

  // C fragment: rows lane/4 (+8), cols 2 * (lane % 4) (+1) of each n8 tile
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long gm = m0 + wm * 16 + lane / 4 + (e / 2) * 8;
      const int gn = n0 + wn * 32 + j * 8 + 2 * (lane % 4) + (e % 2);
      if (gm >= M || gn >= N) continue;
      if (split)
        atomicAdd(c + gm * N + gn, acc[j][e]);
      else
        c[gm * N + gn] = acc[j][e];
    }
}

}  // namespace bb

}  // namespace

// a: (M, K) 32-bit words, w: (K, N) int8, c: (M, N) 32-bit words; wt:
// (Np, Kp) int8 scratch (Kp, Np multiples of 128, >= K, N).  route 0: the
// weight pass into wt, then the tensor-core product with per_split K
// stages a split-K block; 1: the CUDA-core product (wt unused); 2: the
// weight pass alone.
extern "C" int bin_weight_matmul_launch(const void* a, const void* w,
                                        void* wt, void* c, long long M,
                                        int K, int N, int Kp, int Np,
                                        int route, int per_split,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 1) {
    ring_tile::ring_tile_kernel<int8_t>
        <<<ring_tile::tile_grid(M, N), ring_tile::THREADS, 0, st>>>(
            (const uint32_t*)a, (const int8_t*)w, (uint32_t*)c, M, K, N);
    return (int)cudaGetLastError();
  }
  if (route != 0 && route != 2) return (int)cudaErrorInvalidValue;
  if (Kp % 128 || Np % 128 || Kp < K || Np < N || per_split < 1
      || (uintptr_t)c % 16)
    return (int)cudaErrorInvalidValue;
  // the product adds split-K partial sums into c: the pass zeroes it
  const int steps = (K + limb_mma::BK - 1) / limb_mma::BK;
  const bool split = route == 0 && K > 0 && steps > per_split;
  weight_t_kernel<<<dim3(Kp / T_TILE, Np / T_TILE), T_THREADS, 0, st>>>(
      (const int8_t*)w, (uint32_t*)wt, K, N, Kp,
      split ? (uint32_t*)c : nullptr, M * N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || route == 2) return (int)e;
  return limb_mma::launch<1, 1>(a, wt, c, 1, M, K, N, Kp, Np, 0, per_split,
                                st, split);
}

// a: (M, K) int8, w: (K, N) int8, c: (M, N) int32.
extern "C" int bin_bin_matmul_launch(const void* a, const void* w, void* c,
                                     long long M, int K, int N,
                                     void* stream) {
  using namespace bb;
  cudaStream_t st = (cudaStream_t)stream;
  if (K == 0)
    return (int)cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), st);
  const long long m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const long long tiles = m_tiles * n_tiles;
  const int n_slabs = (K + BK - 1) / BK;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // split K until the grid has about one block per SM
  int per = n_slabs;
  if (tiles < sms) {
    const int want = (int)((sms + tiles - 1) / tiles);
    per = (n_slabs + want - 1) / want;
  }
  const int splits = (n_slabs + per - 1) / per;
  if (splits > 1) {
    const cudaError_t e =
        cudaMemsetAsync(c, 0, (size_t)M * N * sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)m_tiles, n_tiles, splits);
  const bool aligned = K % 16 == 0 && N % 16 == 0
      && (uintptr_t)a % 16 == 0 && (uintptr_t)w % 16 == 0;
  if (aligned) {
    const cudaError_t e = cudaFuncSetAttribute(
        bin_bin_matmul_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_ALIGNED);
    if (e != cudaSuccess) return (int)e;
    bin_bin_matmul_kernel<true><<<grid, THREADS, SMEM_ALIGNED, st>>>(
        (const int8_t*)a, (const int8_t*)w, (int32_t*)c, M, K, N, per * BK);
  } else {
    bin_bin_matmul_kernel<false><<<grid, THREADS, SMEM_GATHER, st>>>(
        (const int8_t*)a, (const int8_t*)w, (int32_t*)c, M, K, N, per * BK);
  }
  return (int)cudaGetLastError();
}
