// Causal GQA flash attention (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (pallas_call in flash_attention).  It is the flash_impl of the LM prefill
// step (kernels/ops.py::flash_attention_op): one launch per attention layer.
//
// q (B, S, H, hd), k/v (B, S, Hkv, hd), bfloat16 or float32, read through
// their strides (the last dim contiguous); out (B, S, H, hd) contiguous, in
// q's dtype.  Eight instantiations: bf16 at hd 32, 64, 96 and 128 on the
// tensor cores, and float32 at the same four widths on the CUDA cores.
//
// Common to both routes: one block per (q tile, head, batch).  The block
// walks the K/V tiles up to its causal frontier min(S, (tile + 1) * 64)
// with an online softmax (the Pallas kernel's (m, l, acc) carry), and ends
// with acc / max(l, 1e-30); the score tile never leaves the SM.  GQA: the
// kv head is h / (H / Hkv), so K/V are never repeated per q head.  The
// ragged last tile is masked, so every S launches (the reference falls back
// to its oracle when S is not a multiple of its tile).  The longest tiles
// (the last q tiles, which see the most keys) are launched first.
//
// bf16 route (flash_bf16_kernel, the prefill step's): one warpgroup (four
// warps, 16 query rows each) per 64-row tile; 64-key tiles.
//  * Q·Kᵀ: wgmma m64n64k16 bf16 -> f32 with both operands in shared memory
//    by descriptor (Q and the K tile are hd-contiguous: K-major).  bf16
//    products are exact in f32, so the scores are the float32 dot products
//    up to summation order.  The 1/sqrt(hd) scale (times log2 e) is applied
//    to the float32 scores inside exp2's argument, not to bf16 q.
//  * Online softmax on the accumulator fragments: each thread holds two
//    rows (lane/4 and lane/4 + 8); row maxima are reduced over the four
//    lanes of a row with shuffles; l is summed from float32 p.
//  * P·V twice: wgmma m64n{hd}k16 with A = p_hi = bf16(p) and A = p_lo =
//    bf16(p - p_hi), both from the score registers, B = the V tile
//    (hd-contiguous: MN-major, transposed by the descriptor).  Rounding P
//    once to bf16 (the usual FlashAttention-2 step) puts outputs near zero
//    outside one bf16 rounding of the float32 result; hi + lo carries p to
//    ~16 bits and keeps every output within it (the check is
//    tests/test_torch_flash.py's P-split test).  The extra product is this
//    kernel's cost: 1.5x the tensor-core work of the function.
//  * K/V staging: a two-stage shared-memory ring filled by 16-byte
//    cp.async (rows past S are zero-filled), so tile t+1 loads while tile t
//    multiplies; fence.proxy.async hands the tiles to wgmma.  Tiles are in
//    the canonical GMMA layout, cut into column blocks of 64 (hd 64, 128:
//    128-byte swizzle) or 32 (hd 32, 96: 64-byte swizzle) elements, which
//    also keeps the copies free of bank conflicts.  A row wider than one
//    swizzle atom spans two (hd 128) or three (hd 96) blocks: Q·Kᵀ's k16
//    steps move the descriptors' start address from block to block, and
//    P·V's V descriptor carries the blocks' distance as its leading byte
//    offset (N = hd is MN-major there).  hd 96 takes three 32-column blocks
//    rather than 128 padded columns: every tile is whole swizzle atoms, n96
//    spans exactly three MN atoms of V, and the shared memory is 62 KB, not
//    83 KB.  The wrapper checks the 16-byte alignment the copies need (base
//    pointers, strides multiples of 8).
//  * Masks: only a block's last K/V tile (the diagonal one, also the
//    ragged one) is masked, key > row -> -inf.  Key 0 is in every row's
//    first tile, so the running max is finite after it.
//  * Registers: each wgmma's accumulator and A registers are pinned around
//    its fence and wait (reg_fence).  Q stays in shared memory: A fragments
//    held in registers across loop iterations were corrupted at hd 64.
//    A thread holds hd / 2 accumulator floats (64 at hd 128) beside its 32
//    scores and 32 p_hi / p_lo registers.
//
// float32 route (flash_f32_kernel): the reference's kernel-test shapes, held
// to its 2e-5, which no bf16 or TF32 tensor-core product can meet.  One
// thread per query row keeps its scaled q row and acc in registers (2 hd
// floats: at hd 128 more than a thread's 255 registers, so part of them
// spills to local memory, as chip_smoke.py's ptxas lines show); 32-key K/V
// tiles in shared memory as float32; FMAs on the CUDA cores.  No path of
// the system passes float32 here.
//
// What bounds it: the work is 4 * B * H * hd * S(S+1)/2 flops; at the
// TinyLlama shape (2, 2048, 32, 4, 64) in bf16 the tensor cores would take
// ~35 us for it (989 TFLOP/s), at deepseek-67b's (2, 2048, 64, 8, 128)
// ~139 us.  The p_lo product adds half again, and the
// softmax between the two products is instruction-bound; see PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores, one thread per query row
// ---------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows of a block, one thread each
constexpr int BK = 32;   // keys staged in shared memory at a time

template <int HD>
__global__ void __launch_bounds__(BQ) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int H,
    int Hkv, long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale) {
  __shared__ __align__(16) float ks[BK][HD];
  __shared__ __align__(16) float vs[BK][HD];
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = qt * BQ + threadIdx.x;
  const bool valid = row < S;

  float qr[HD], acc[HD];
  const float* qp = q + b * sqb + (long long)(valid ? row : 0) * sqs
      + h * sqh;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = valid ? qp[d] * scale : 0.f;
    acc[d] = 0.f;
  }
  // Rows past S (the ragged tile) compute on zeros and are not stored.
  float m = -INFINITY, l = 0.f;

  const int n_keys = min(S, (qt + 1) * BQ);   // causal frontier of the tile
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < BK * HD; idx += BQ) {
      const int j = idx / HD, d = idx % HD;
      const int key = k0 + j;
      ks[j][d] = key < S ? kb[key * sks + d] : 0.f;
      vs[j][d] = key < S ? vb[key * svs + d] : 0.f;
    }
    __syncthreads();
    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      s[j] = (k0 + j <= row) ? dot : -INFINITY;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }
  if (valid) {
    float* op = o + (((long long)b * S + row) * H + h) * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = acc[d] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), cp.async K/V ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;           // query rows of a block: one warpgroup
constexpr int TK = 64;           // keys of a K/V tile
constexpr int THREADS = 128;     // 4 warps, 16 query rows each
constexpr int STAGES = 2;        // K/V tiles in flight

// Shared tiles hold 64 rows of hd bf16 in the canonical GMMA layout, cut
// into NB column blocks of BW elements: BW 64 (hd 64, 128) in the 128-byte
// swizzle, BW 32 (hd 32, 96) in the 64-byte one.  Block j holds columns
// [j BW, (j + 1) BW) of every row, ROWB bytes a row; 16-byte chunk c of its
// row r sits at chunk c ^ ((r >> SHIFT) % CPB), and eight rows form one
// swizzle atom.  The same layout is K-major for Kᵀ (B of Q·Kᵀ) and
// MN-major for V (B of P·V, transposed by the descriptor, whose leading
// byte offset steps from one block to the next).
template <int HD>
struct Tile {
  static_assert(HD % 32 == 0, "head widths are multiples of 32");
  static constexpr int BW = HD % 64 == 0 ? 64 : 32;  // columns of a block
  static constexpr int NB = HD / BW;                 // blocks of a row
  static constexpr int ROWB = BW * 2;                // bytes of a block row
  static constexpr int CPB = ROWB / 16;              // its 16-byte chunks
  static constexpr int CHUNKS = HD / 8;              // chunks of a row
  static constexpr int SHIFT = BW == 64 ? 0 : 1;
  static constexpr int ATOM = 8 * ROWB;              // bytes of 8 rows
  static constexpr int BLOCK = TK * ROWB;            // bytes of a block
  static constexpr int LAYOUT = BW == 64 ? 1 : 2;    // 128B / 64B swizzle
  static constexpr int BYTES = NB * BLOCK;           // one Q, K or V tile
  static constexpr int SMEM = (1 + 2 * STAGES) * BYTES + 1024;  // + align
  // P·V's leading byte offset: the next MN block of V (unused at NB 1)
  static constexpr int LBO = NB > 1 ? BLOCK : 16;
  __device__ static int off(int r, int c) {
    return (c / CPB) * BLOCK + r * ROWB
        + (((c % CPB) ^ ((r >> SHIFT) & (CPB - 1))) << 4);
  }
  // where k16 step kk (columns 16 kk ...) of row 0 starts: Q·Kᵀ's K-major
  // start address moves within a block row, then to the next block
  __device__ static constexpr int kstep(int kk) {
    return (16 * kk / BW) * BLOCK + (16 * kk % BW) * 2;
  }
};
static_assert(TQ == TK, "a block's last K/V tile is its only diagonal one");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
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

// GMMA shared-memory descriptor: start address, leading / stride byte
// offsets (stored in 16-byte units), layout (1 = 128B swizzle, 2 = 64B
// swizzle).  K-major swizzled operands ignore the leading offset (16 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int lbo,
                                              int sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
      | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
      | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
      | ((uint64_t)layout << 62);
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
// Pin registers in program order: writes before the fence are done by it,
// reads after it happen after it.  Every register a wgmma reads or writes
// is fenced before its wgmma.fence and after its wait_group, so no plain
// instruction touches it while the product is in flight.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d (64 x N f32, this warp's 16 rows) (+)= a (64 x 16 bf16, registers) *
// b (16 x N bf16, MN-major in shared memory by descriptor)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate);

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47}, "
      "{%48,%49,%50,%51}, %52, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}
// d (64 x 64 f32) (+)= a (64 x 16 bf16) * b (16 x 64 bf16), both K-major in
// shared memory by descriptor
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef WG_D8

// 2^x in one MUFU op (results below 2^-126 flush to 0: p that small adds
// nothing to a row sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + 64) of one head's (S, HD) slice -> a swizzled shared tile.
// The tile's 64 x CHUNKS 16-byte chunks are dealt out in row order, so
// neighbouring threads read neighbouring chunks of a row.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long stride, int r0, int S,
                                          int tid) {
  using T = Tile<HD>;
  static_assert(TK * T::CHUNKS % THREADS == 0, "whole copy rounds");
#pragma unroll
  for (int j = 0; j < TK * T::CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / T::CHUNKS, c = i % T::CHUNKS;
    const bool ok = r0 + r < S;
    cp_async16(dst + T::off(r, c),
               ok ? src + (long long)(r0 + r) * stride + c * 8 : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int Hkv,
    long long sqb, long long sqs, long long sqh, long long skb,
    long long sks, long long skh, long long svb, long long svs,
    long long svh, float scale_log2) {
  using T = Tile<HD>;
  constexpr int NT = TK / 8;     // n8 column blocks of the score tile
  constexpr int DT = HD / 8;     // n8 column blocks of the output
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms must sit on 1024-byte boundaries
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks = qs + T::BYTES;                  // STAGES K tiles
  const uint32_t vs = ks + STAGES * T::BYTES;         // STAGES V tiles

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // longest tiles first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * TQ;
  const int n_tiles = (min(S, q0 + TQ) + TK - 1) / TK;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  load_tile<HD>(qs, q + b * sqb + h * sqh, sqs, q0, S, tid);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      load_tile<HD>(ks + s * T::BYTES, kb, sks, s * TK, S, tid);
      load_tile<HD>(vs + s * T::BYTES, vb, svs, s * TK, S, tid);
    }
    cp_async_commit();            // group s (group 0 holds Q too)
  }

  float acc[HD / 2];             // this warp's 16 output rows, DT blocks
  float sc[TK / 2];              // its 16 rows of the score tile
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};               // this thread's partial row sums
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    const int nxt = t + STAGES - 1;
    if (nxt < n_tiles) {
      load_tile<HD>(ks + (nxt % STAGES) * T::BYTES, kb, sks, nxt * TK, S,
                    tid);
      load_tile<HD>(vs + (nxt % STAGES) * T::BYTES, vb, svs, nxt * TK, S,
                    tid);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // tile t (and Q) have landed
    fence_async_shared();
    __syncthreads();
    const uint32_t kt = ks + (t % STAGES) * T::BYTES;
    const uint32_t vt = vs + (t % STAGES) * T::BYTES;

    // S = Q Kᵀ: 64 rows x 64 keys, hd / 16 steps of k16 (32 bytes a row)
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss(sc, gmma_desc(qs + T::kstep(kk), 16, T::ATOM, T::LAYOUT),
               gmma_desc(kt + T::kstep(kk), 16, T::ATOM, T::LAYOUT), kk);
    wgmma_commit();
    wgmma_wait();
    reg_fence(sc);

    // online softmax on the unscaled scores (the scale is folded into
    // exp2's argument); sc[4j + e] is row g + 8 (e / 2), key 8j + 2 t4 + e % 2
    // of the tile.  The diagonal (= last) tile starts at key q0: mask key >
    // row there.
    if (t == n_tiles - 1) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * 8 + 2 * t4 + (e % 2) > warp * 16 + g + (e / 2) * 8)
            sc[4 * j + e] = -INFINITY;
    }
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mt[e / 2] = fmaxf(mt[e / 2], sc[4 * j + e]);
    float mc[2];                           // the row max, scaled
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      // 0 on the first tile
      const float alpha = ex2((m[r] - mt[r]) * scale_log2);
      m[r] = mt[r];
      mc[r] = mt[r] * scale_log2;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[4 * j + 2 * r] *= alpha;
        acc[4 * j + 2 * r + 1] *= alpha;
      }
    }

    // P as bf16 hi + lo, in the A-fragment order of each 16-key step
    uint32_t ph[TK / 16][4], pl[TK / 16][4];
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc)
#pragma unroll
      for (int half = 0; half < 2; ++half)       // keys +0..7, +8..15
#pragma unroll
        for (int r = 0; r < 2; ++r) {            // rows g, g + 8
          const float* s = sc + 4 * (2 * kc + half) + 2 * r;
          const float p0 = ex2(fmaf(s[0], scale_log2, -mc[r]));
          const float p1 = ex2(fmaf(s[1], scale_log2, -mc[r]));
          l[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          ph[kc][2 * half + r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[kc][2 * half + r] = pack_bf16(p0 - __low2float(hi),
                                           p1 - __high2float(hi));
        }

    // O += P V: V's 16-key steps are two swizzle atoms apart, its column
    // blocks T::LBO bytes
    reg_fence(ph);
    reg_fence(pl);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < TK / 16; ++kc) {
      const uint64_t dv =
          gmma_desc(vt + kc * 2 * T::ATOM, T::LBO, T::ATOM, T::LAYOUT);
      wgmma_rs<HD>(acc, ph[kc], dv, 1);
      wgmma_rs<HD>(acc, pl[kc], dv, 1);
    }
    wgmma_commit();
    wgmma_wait();
    reg_fence(ph);
    reg_fence(pl);
    reg_fence(acc);
    __syncthreads();   // this stage is refilled next iteration
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    bf16* op = o + (((long long)b * S + row) * H + h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, const long long* st, float scale,
               cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_f32_kernel<HD><<<grid, BQ, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
      Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, const long long* st, float scale,
                cudaStream_t stream) {
  constexpr int smem = Tile<HD>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (S + TQ - 1) / TQ);
  flash_bf16_kernel<HD><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale * 1.4426950408889634f);   // log2 e: the softmax runs on exp2
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; hd in {32, 64, 96, 128}; strides in
// elements of
// (batch, seq, head) for q, k, v.  bfloat16 needs 16-byte aligned bases and
// strides that are multiples of 8 (the wrapper checks).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int H, int Hkv, int hd, int dtype, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, float scale,
    void* stream) {
  const long long st[9] = {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
#define FLASH_WIDTH(HD)                                                  \
  if (hd == HD)                                                          \
    return dtype == 0                                                    \
        ? launch_f32<HD>(q, k, v, o, B, S, H, Hkv, st, scale, s)         \
        : launch_bf16<HD>(q, k, v, o, B, S, H, Hkv, st, scale, s);
  FLASH_WIDTH(32)
  FLASH_WIDTH(64)
  FLASH_WIDTH(96)
  FLASH_WIDTH(128)
#undef FLASH_WIDTH
  return (int)cudaErrorInvalidValue;
}
