// Ring products on the int8 tensor cores over limbs (Hopper, sm_90a), the
// tensor-core route of B1 (rss_matmul.cu) and B3 (bin_rss_matmul.cu).
//
// For each share slot s of an (S, M, K) stack of 32-bit ring words x and
// each of OPS operands o it adds
//
//     z_s += x_{(s+o) % S} · W_{s,o}      (mod 2^32)
//
// or, given the neighbour stack xn (B1's pair entry: one party holding
// its pair [x_i, x_{i+1}], S = 1), x_s for o = 0 and xn_s for o = 1.
//
// where W_{s,o} is given as L int8 limbs, K-major and 128-padded:
// (S_w, OPS, L, Np, Kp), S_w = S (B1: o = 0 the fused operand wf_s, o = 1
// the share ws_s, which multiplies x_{s+1}) or 1 (B3: one public weight,
// slot stride 0).
//
// Arithmetic.  The four bytes of a word are its unsigned limbs,
// x ≡ Σ_p u_p 2^{8p}; the weight limbs are the reference's balanced signed
// ones, w ≡ Σ_q v_q 2^{8q}.  wgmma .s32.u8.s8 multiplies u_p by v_q
// exactly; terms with p + q >= 4 vanish mod 2^32, so the pairs with
// p + q = s add into one int32 accumulator set per shift s (4 sets: 10
// pairs an operand with L = 4, Σ_{q<L}(4 − q) in general), and the output
// is Σ_s acc_s << 8s.  No .satfinite: the int32 sums wrap, and only acc_s
// mod 2^{32-8s} reaches the result, so every K is exact.
//
// Tiles.  One warpgroup (4 warps, 16 rows each) owns one slot's 64 x 64
// output tile; the S slots of a tile are neighbours in the grid, so the x
// tile that slot s reads as its second operand is in L2 from slot s+1's
// read.  K runs in 32-deep stages through a three-stage cp.async ring: x
// as raw words (16-byte copies where K is a multiple of 4 and x 16-byte
// aligned, else 4-byte copies; zero-filled past M and past the block's K
// range) and the weight limbs as 16-byte copies that need no mask (the
// cache is padded).  Each warp loads its x rows with 16-byte shared loads
// and splits every four words into the four limb registers with byte
// permutes: the A fragments of all four limbs.  Every limb pair is then
// one wgmma m64n64k32 with A in those registers and B (a weight limb
// plane, K-major in the GMMA 32-byte swizzle) by descriptor; the A and
// accumulator registers are pinned around each fence and wait (reg_fence),
// as in flash_attention.cu.  The x layout is XOR-swizzled so the shared
// loads and the cp.async stores are free of bank conflicts.
//
// Split-K.  blockIdx.y selects a range of K stages; with more than one
// range the blocks add their partial sums with int32 atomics into an
// output zeroed on the same stream first.  Addition mod 2^32 does not
// depend on order, so repeats are bit-identical.
//
// What bounds it: at the classifiers' conv shapes, the int8 operations
// (2·dots·M·K·N a slot) or the x words; at M = 32, the weight limbs' bytes
// (split-K keeps enough copies in flight).  A 64-row wgmma tile wastes half
// its rows at M = 32, but measured as fast as mma.sync m16n8k32 there once
// K is split, and 17–23% faster at the conv shapes.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace limb_mma {

constexpr int BM = 64;               // output rows of a block
constexpr int BN = 64;               // output cols of a block
constexpr int BK = 32;               // K of a stage: one k32 step
constexpr int THREADS = 128;         // one warpgroup, 16 rows a warp
constexpr int STAGES = 3;
constexpr int X_BYTES = BM * BK * 4;  // one operand's x rows, 128 B each
constexpr int W_BYTES = BN * BK;      // one limb's weight rows, 32 B each

template <int OPS, int L>
__host__ __device__ constexpr int stage_bytes() {
  return OPS * (X_BYTES + L * W_BYTES);
}

// byte offset of 16-byte chunk c (words 4c..4c+3) of x row r: odd rows
// swap the halves, so the two rows of each 8-lane phase of a fragment load
// (chunks 0-3 or 4-7 of rows 2i, 2i+1) hit all 32 banks
__device__ __forceinline__ int x_off(int r, int c) {
  return r * (BK * 4) + ((c ^ ((r & 1) << 2)) << 4);
}
// byte offset of 16-byte chunk c (k 16c..16c+15) of weight row n: the
// GMMA 32-byte swizzle (chunk ^= bit 2 of the row)
__device__ __forceinline__ int w_off(int n, int c) {
  return n * BK + ((c ^ ((n >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's generic-proxy writes (cp.async) visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// GMMA shared-memory descriptor of a K-major weight limb plane: start
// address, stride byte offset between 8-row groups (256), layout 3
// (32-byte swizzle)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
      | ((uint64_t)((8 * BK) >> 4) << 32) | ((uint64_t)3 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers in program order: every register a wgmma reads or writes
// is fenced before its wgmma.fence and after its wait_group, so no plain
// instruction touches it while the product is in flight.
__device__ __forceinline__ void reg_fence(int32_t (&d)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

#define WG_D8(j) "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3]), \
    "+r"(d[j + 1][0]), "+r"(d[j + 1][1]), "+r"(d[j + 1][2]), "+r"(d[j + 1][3])
// d (64 x 64 s32, this warp's 16 rows as 8 n8 tiles of the mma C layout)
// += a (64 x 32 u8, registers) * b (32 x 64 s8, K-major in shared memory
// by descriptor); the int32 sums wrap
__device__ __forceinline__ void wgmma_u8s8(int32_t (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p;\n}\n"
      : WG_D8(0), WG_D8(2), WG_D8(4), WG_D8(6)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
#undef WG_D8

// four words (k, k+1, k+2, k+3) -> a[p][j] = their bytes p (limb p),
// in k order: a 4 x 4 byte transpose
__device__ __forceinline__ void split_limbs(const uint4 v, uint32_t (&a)[4][4],
                                            int j) {
  const uint32_t t0 = __byte_perm(v.x, v.y, 0x5140);
  const uint32_t t1 = __byte_perm(v.x, v.y, 0x7362);
  const uint32_t t2 = __byte_perm(v.z, v.w, 0x5140);
  const uint32_t t3 = __byte_perm(v.z, v.w, 0x7362);
  a[0][j] = __byte_perm(t0, t2, 0x5410);
  a[1][j] = __byte_perm(t0, t2, 0x7632);
  a[2][j] = __byte_perm(t1, t3, 0x5410);
  a[3][j] = __byte_perm(t1, t3, 0x7632);
}

// One K stage into shared memory: x rows m0.. of each operand's slot as
// raw words (zero past M and past kend), the weight limbs' rows n0.. as
// 16-byte copies.
template <int OPS, int L>
__device__ __forceinline__ void load_stage(
    uint8_t* st, int tid, const uint32_t* const* xo, const uint32_t* x,
    const int8_t* ws, long long plane, long long m0, int n0, int k0,
    int kend, long long M, int K, int Kp, bool vec) {
#pragma unroll
  for (int j = 0; j < OPS * BM * 8 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int o = i / (BM * 8), r = (i / 8) % BM, c = i % 8;
    const long long gm = m0 + r;
    const int gk = k0 + 4 * c;
    uint8_t* dst = st + o * X_BYTES + x_off(r, c);
    const uint32_t* src = xo[o] + gm * K + gk;
    if (vec) {
      const bool ok = gm < M && gk < kend;
      cp_async16(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gm < M && gk + e < kend;
        cp_async4(dst + 4 * e, ok ? src + e : x, ok);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < OPS * L * BN * 2 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int pl = i / (BN * 2), n = (i / 2) % BN, c = i % 2;
    cp_async16(st + OPS * X_BYTES + pl * W_BYTES + w_off(n, c),
               ws + pl * plane + (long long)(n0 + n) * Kp + k0 + 16 * c, true);
  }
}

template <int OPS, int L>
__global__ void __launch_bounds__(THREADS, 2)
limb_mma_kernel(const uint32_t* __restrict__ x,
                const uint32_t* __restrict__ xn,
                const int8_t* __restrict__ w,
                uint32_t* __restrict__ z, int S, long long M, int K, int N,
                int Kp, int Np, long long w_slot_stride, int n_tiles,
                int k_split, bool vec) {
  constexpr int STAGE = stage_bytes<OPS, L>();
  extern __shared__ uint8_t smem_raw[];
  // the swizzle repeats every 256 bytes: align the stages to 1024
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  // slot fastest, then the n tile: the blocks that share x rows run together
  const long long b = blockIdx.x;
  const int s = (int)(b % S);
  const int n0 = (int)((b / S) % n_tiles) * BN;
  const long long m0 = b / S / n_tiles * BM;
  const int kbeg = blockIdx.y * k_split;
  const int kend = min(K, kbeg + k_split);
  const int steps = (kend - kbeg + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;

  const uint32_t* xo[OPS];
#pragma unroll
  for (int o = 0; o < OPS; ++o)
    xo[o] = (o == 1 && xn != nullptr) ? xn + (long long)s * M * K
                                      : x + (long long)((s + o) % S) * M * K;
  const int8_t* ws = w + s * w_slot_stride;
  const long long plane = (long long)Np * Kp;
  auto load = [&](int t, int stage) {
    load_stage<OPS, L>(smem + stage * STAGE, tid, xo, x, ws, plane, m0, n0,
                       kbeg + t * BK, kend, M, K, Kp, vec);
  };

  int32_t acc[4][8][4];   // [shift][n8 tile][fragment]
#pragma unroll
  for (int sh = 0; sh < 4; ++sh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sh][j][e] = 0;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();   // step t has landed
    fence_async_shared();          // visible to the async proxy (wgmma)
    __syncthreads();               // and every warp is done with step t-1
    const int nxt = t + STAGES - 1;
    if (nxt < steps) load(nxt, nxt % STAGES);   // into step t-1's stage
    cp_async_commit();
    const uint8_t* st = smem + (t % STAGES) * STAGE;
#pragma unroll
    for (int o = 0; o < OPS; ++o) {
      // A fragments of all four limbs: rows r0 / r0 + 8, k 4tq.. / 16 + 4tq..
      const uint8_t* xs = st + o * X_BYTES;
      uint32_t a[4][4];
      split_limbs(*reinterpret_cast<const uint4*>(xs + x_off(r0, tq)), a, 0);
      split_limbs(*reinterpret_cast<const uint4*>(xs + x_off(r0 + 8, tq)), a,
                  1);
      split_limbs(*reinterpret_cast<const uint4*>(xs + x_off(r0, tq + 4)), a,
                  2);
      split_limbs(*reinterpret_cast<const uint4*>(xs + x_off(r0 + 8, tq + 4)),
                  a, 3);
      const uint32_t wsm = smem_addr(st + OPS * X_BYTES + o * L * W_BYTES);
      reg_fence(a);
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) reg_fence(acc[sh]);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < L; ++q)
#pragma unroll
        for (int p = 0; p < 4 - q; ++p)
          wgmma_u8s8(acc[p + q], a[p], gmma_desc(wsm + q * W_BYTES));
      wgmma_commit();
      wgmma_wait();
      reg_fence(a);
#pragma unroll
      for (int sh = 0; sh < 4; ++sh) reg_fence(acc[sh]);
    }
  }
  cp_async_wait<0>();

  // C fragment: rows r0 (+8), cols 2 tq (+1) of each n8 tile
  const bool split = gridDim.y > 1;
  uint32_t* zs = z + (long long)s * M * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long gm = m0 + r0 + (e / 2) * 8;
      const int gn = n0 + j * 8 + 2 * tq + (e % 2);
      if (gm >= M || gn >= N) continue;
      const uint32_t v = (uint32_t)acc[0][j][e]
          + ((uint32_t)acc[1][j][e] << 8) + ((uint32_t)acc[2][j][e] << 16)
          + ((uint32_t)acc[3][j][e] << 24);
      if (split)
        atomicAdd(zs + gm * N + gn, v);
      else
        zs[gm * N + gn] = v;
    }
}

// x (S, M, K) words, w (S_w, OPS, L, Np, Kp) int8 limbs (w_slot_stride 0
// for one weight shared by every slot), z (S, M, N) words; per_split K
// stages a block.  zeroed: the caller has zeroed z on the stream already
// (a split-K launch adds into it).  xn: the neighbour stack (S, M, K) that
// operand 1 reads, or null for x_{(s+1) % S}.
template <int OPS, int L>
int launch(const void* x, const void* w, void* z, int S, long long M, int K,
           int N, int Kp, int Np, long long w_slot_stride, int per_split,
           cudaStream_t st, bool zeroed = false, const void* xn = nullptr) {
  const size_t out_bytes = (size_t)S * M * N * sizeof(uint32_t);
  if (K == 0) return (int)cudaMemsetAsync(z, 0, out_bytes, st);
  if (per_split < 1 || Kp % BK || Np % BN || Kp < K || Np < N)
    return (int)cudaErrorInvalidValue;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  const int steps = (K + BK - 1) / BK;
  const int splits = (steps + per_split - 1) / per_split;
  if (splits > 1 && !zeroed) {
    const cudaError_t e = cudaMemsetAsync(z, 0, out_bytes, st);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int smem = STAGES * stage_bytes<OPS, L>() + 1024;   // + align
  const cudaError_t e = cudaFuncSetAttribute(
      limb_mma_kernel<OPS, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec = K % 4 == 0 && (uintptr_t)x % 16 == 0
      && (uintptr_t)xn % 16 == 0;
  const dim3 grid((unsigned)(S * m_tiles * n_tiles), (unsigned)splits);
  limb_mma_kernel<OPS, L><<<grid, THREADS, smem, st>>>(
      (const uint32_t*)x, (const uint32_t*)xn, (const int8_t*)w,
      (uint32_t*)z, S, M, K, N, Kp, Np, w_slot_stride, n_tiles,
      per_split * BK, vec);
  return (int)cudaGetLastError();
}

}  // namespace limb_mma
