// Grouped (depthwise) 3-party RSS product, all parties in one launch
// (Hopper, sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/bin_rss_matmul.py::_make_grouped_shared_kernel
// (pallas_call in _grouped_shared_call).  Per party p and channel c:
//
//     z_p[c] = x_p[c] · wf_p[c] + x_{(p+1) % S}[c] · ws_p[c]   (mod 2^32)
//
// with x_p[c] an (M, K) patch matrix (K = kh·kw: 9 or 25 in the nets) and
// wf_p[c], ws_p[c] (K, N) slabs (N = 1: depthwise multiplier 1).  The TPU
// kernel decomposed every word into int8 limbs for its MXU; here the words
// are multiplied with 32-bit IMADs and accumulated in uint32_t (wrap = ring
// arithmetic).  Tensor-core tiles would be mostly padding at K <= 25,
// N = 1.
//
// What bounds it: bytes.  Each x word takes part in two multiply-adds,
// z_p's own product and z_{p-1}'s neighbour product, so the floor is x
// read once plus z written once over 3.35 TB/s.  The design keeps to it:
//
//  * One thread owns one (m, channel group) row for all S parties and
//    reads each share slot's row x_s[c, m, :] once, for both products it
//    enters (party_walk_kernel): it walks the parties in order, adding x_s
//    into z_s (with wf_s) and into z_{s-1} (with ws_{s-1}); z_{s-1} is
//    complete after party s and stored then, z_{S-1} after the walk, with
//    x_0's term kept from its start.  Any S runs (S = 1: the per-party
//    mode).
//  * All K loads of a row are issued before its first multiply-add: the
//    kernel is templated on K = 9 and 25 (the nets' 3 x 3 and 5 x 5
//    windows) and a generic instantiation takes any other K in register
//    chunks of 25.  The next party's row is loaded while this one is
//    multiplied (where two rows fit the registers), and a thread's first
//    row is loaded before the weights are staged.
//  * x is read through its strides, so the secure path hands over the
//    im2col (S, M, K, C) buffer as an (S, C, M, K) view and no transpose is
//    materialised.  In that channel-contiguous layout a thread takes 4
//    neighbouring channels with 16-byte loads where C % 4 == 0 and the
//    base and strides are 16-byte multiples, and writes its 4 z words of a
//    party with one 16-byte store when N = 1.  Otherwise a thread takes
//    one channel with 4-byte loads (CifarNet2's C = 3, or the (S, C, M, K)
//    layout's 36-byte rows); neighbouring threads take neighbouring
//    channels, or rows in the (S, C, M, K) layout, so loads coalesce.
//  * The weight slabs of all S parties (2·S·C·K·N words) are staged once a
//    block in shared memory as [S][2][N][K][C], channel fastest, so the 4
//    channels' weights are one 16-byte shared load; above 48 KB the kernel
//    opts in to more.  A block takes 128 rows; past 16 blocks an SM the
//    blocks stride over the rows, so a large slab is staged a bounded
//    number of times.
//
// At CifarNet2's shapes a launch moves 7–63 MB, so the fixed cost of a
// launch (about 5 µs between two CUDA events on the H100, whatever the
// kernel) is a large share of each one.
//
// per_party_kernel is the first design (kept for chip_smoke.py's same-call
// comparison): the party on blockIdx.y, each thread one (channel, m) row of
// one party with a K loop of dependent loads.  It reads every share slot of
// x twice, once as x_p and once as party p-1's x_{p+1}, a grid apart: from
// device memory once a layer's x exceeds the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int K_CHUNK = 25;          // K words of a row in registers
constexpr int BLOCKS_PER_SM = 16;    // 2048 threads: a full SM
constexpr int OLD_THREADS = 256;
constexpr int OLD_MAX_BLOCKS = 132 * 16;
constexpr size_t SMEM_DEFAULT = 48 * 1024;

struct Args {
  const uint32_t* x;
  const uint32_t* wf;
  const uint32_t* ws;
  uint32_t* z;
  int S, C, K, N;
  long long M;
  long long sxs, sxc, sxm, sxk;      // x (S, C, M, K) element strides
  long long szs, szc, szm, szn;      // z (S, C, M, N) element strides
  bool c_fast;                       // channels are the contiguous axis
  bool vec_z;                        // 16-byte z stores (V = 4, N = 1)
};

// V lanes of consecutive words
template <int V>
__device__ __forceinline__ void load_global(uint32_t (&r)[V],
                                            const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    r[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_shared(uint32_t (&r)[V],
                                            const uint32_t* p) {
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
    r[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_z(const Args& a, uint32_t* zp,
                                        const uint32_t (&acc)[V]) {
  if constexpr (V == 4) {
    if (a.vec_z) {
      *reinterpret_cast<uint4*>(zp) = make_uint4(acc[0], acc[1], acc[2],
                                                 acc[3]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) zp[v * a.szc] = acc[v];
}

// the (channel, m) of row-group t: V channels from c
template <int V>
__device__ __forceinline__ void locate(const Args& a, long long t, int& c,
                                       long long& m) {
  const int groups = a.C / V;
  if (a.c_fast) {
    c = (int)(t % groups) * V;
    m = t / groups;
  } else {
    m = t % a.M;
    c = (int)(t / a.M) * V;
  }
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

// the weight slabs of all parties, [S][2][N][K][C] (wf_s, then ws_s), by
// 4-byte async copies all in flight at once; a thread walks the source
// (s, c, k, n) order with its indices stepped, not divided, each time
__device__ __forceinline__ void stage_weights(const Args& a, uint32_t* wsh) {
  const int K = a.K, N = a.N, C = a.C, kn = K * N;
  const int kc = K * C, nkc = N * kc, total = a.S * C * kn;
  if (total == 0) return;   // K = 0: nothing to stage
  const int step = blockDim.x, dq = step / kn, dr = step % kn;
  int e = threadIdx.x % kn, c = threadIdx.x / kn, s = c / C;
  c -= s * C;
  for (int i = threadIdx.x; i < total; i += step) {
    const int k = N == 1 ? e : e / N, n = e - k * N;
    uint32_t* d = wsh + 2 * s * nkc + n * kc + k * C + c;
    cp_async4(d, a.wf + i);
    cp_async4(d + nkc, a.ws + i);
    e += dr;
    c += dq;
    if (e >= kn) {
      e -= kn;
      ++c;
    }
    while (c >= C) {
      c -= C;
      ++s;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Any S, K = KT: a thread walks the parties in order, reading each row
// once (all KT loads first) and adding it into z_s (with wf_s) and into
// z_{s-1} (with ws_{s-1}).  z_{s-1} is complete after party s and is
// stored then; z_{S-1} after the walk, with x_0's term kept from its start.
// The first row's loads are issued before the weights are staged; with
// PIPE the next party's row is in flight while this one is multiplied.
template <int KT, int V, bool PIPE>
__global__ void __launch_bounds__(THREADS)
party_walk_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t wsh[];
  const int S = a.S, C = a.C, N = a.N, kc = KT * C, nkc = N * kc;
  const long long rows = a.M * (C / V);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t xv[KT][V], xn[PIPE ? KT : 1][V];
  int c = 0;
  long long m = 0;
  auto load = [&](auto& dst, int s) {
    const uint32_t* xs = a.x + c * a.sxc + m * a.sxm + s * a.sxs;
#pragma unroll
    for (int k = 0; k < KT; ++k) load_global<V>(dst[k], xs + k * a.sxk);
  };
  if (t < rows) {
    locate<V>(a, t, c, m);
    load(xv, 0);
  }
  stage_weights(a, wsh);
  __syncthreads();
  for (; t < rows; t += stride) {
    uint32_t* zr = a.z + c * a.szc + m * a.szm;
    for (int n = 0; n < N; ++n) {
      if (n > 0) load(xv, 0);
      uint32_t prev[V], wrap[V];
      for (int s = 0; s < S; ++s) {
        if constexpr (PIPE) {
          if (s + 1 < S) load(xn, s + 1);
        }
        const uint32_t* wo = wsh + 2 * s * nkc + n * kc + c;   // wf_s
        const uint32_t* wn =                                    // ws_{s-1}
            wsh + (2 * ((s + S - 1) % S) + 1) * nkc + n * kc + c;
        uint32_t own[V], nb[V];
#pragma unroll
        for (int v = 0; v < V; ++v) own[v] = nb[v] = 0u;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          uint32_t f[V], g[V];
          load_shared<V>(f, wo + k * C);
          load_shared<V>(g, wn + k * C);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            own[v] += xv[k][v] * f[v];
            nb[v] += xv[k][v] * g[v];
          }
        }
        if (s == 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) wrap[v] = nb[v];
        } else {   // z_{s-1} = x_{s-1}·wf_{s-1} + x_s·ws_{s-1}
#pragma unroll
          for (int v = 0; v < V; ++v) nb[v] += prev[v];
          store_z<V>(a, zr + (s - 1) * a.szs + n * a.szn, nb);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) prev[v] = own[v];
        if (s + 1 < S) {
          if constexpr (PIPE) {
#pragma unroll
            for (int k = 0; k < KT; ++k)
#pragma unroll
              for (int v = 0; v < V; ++v) xv[k][v] = xn[k][v];
          } else {
            load(xv, s + 1);
          }
        }
      }
      // z_{S-1} = x_{S-1}·wf_{S-1} + x_0·ws_{S-1}
#pragma unroll
      for (int v = 0; v < V; ++v) prev[v] += wrap[v];
      store_z<V>(a, zr + (S - 1) * a.szs + n * a.szn, prev);
    }
    if (t + stride < rows) {
      locate<V>(a, t + stride, c, m);
      load(xv, 0);
    }
  }
}

// Any S, any K, in register chunks of K_CHUNK words: the same walk, the
// loads of a chunk issued before its first multiply-add.
template <int V>
__global__ void __launch_bounds__(THREADS)
party_walk_any_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t wsh[];
  const int S = a.S, C = a.C, K = a.K, N = a.N;
  const int kc = K * C, nkc = N * kc;
  stage_weights(a, wsh);
  __syncthreads();

  const long long rows = a.M * (C / V);
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < rows; t += (long long)gridDim.x * blockDim.x) {
    int c;
    long long m;
    locate<V>(a, t, c, m);
    const uint32_t* xr = a.x + c * a.sxc + m * a.sxm;
    uint32_t* zr = a.z + c * a.szc + m * a.szm;
    for (int n = 0; n < N; ++n) {
      uint32_t prev[V], wrap[V];
      for (int s = 0; s < S; ++s) {
        const uint32_t* xs = xr + s * a.sxs;
        const uint32_t* wo = wsh + 2 * s * nkc + n * kc + c;
        const uint32_t* wn =
            wsh + (2 * ((s + S - 1) % S) + 1) * nkc + n * kc + c;
        uint32_t own[V], nb[V];
#pragma unroll
        for (int v = 0; v < V; ++v) own[v] = nb[v] = 0u;
        for (int k0 = 0; k0 < K; k0 += K_CHUNK) {
          uint32_t xv[K_CHUNK][V];
#pragma unroll
          for (int j = 0; j < K_CHUNK; ++j)
            if (k0 + j < K) load_global<V>(xv[j], xs + (k0 + j) * a.sxk);
#pragma unroll
          for (int j = 0; j < K_CHUNK; ++j) {
            if (k0 + j >= K) continue;
            uint32_t f[V], g[V];
            load_shared<V>(f, wo + (k0 + j) * C);
            load_shared<V>(g, wn + (k0 + j) * C);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              own[v] += xv[j][v] * f[v];
              nb[v] += xv[j][v] * g[v];
            }
          }
        }
        if (s == 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) wrap[v] = nb[v];
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) nb[v] += prev[v];
          store_z<V>(a, zr + (s - 1) * a.szs + n * a.szn, nb);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) prev[v] = own[v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) prev[v] += wrap[v];
      store_z<V>(a, zr + (S - 1) * a.szs + n * a.szn, prev);
    }
  }
}

// One block a THREADS-row slice, at most BLOCKS_PER_SM blocks an SM (past
// that the blocks stride over the rows, so a large slab is staged a bounded
// number of times).
int launch_rows(void (*kernel)(const Args), const Args& a, int V,
                size_t smem, cudaStream_t st) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows = a.M * (a.C / V);
  long long blocks = (rows + THREADS - 1) / THREADS;
  if (blocks > (long long)BLOCKS_PER_SM * sms)
    blocks = (long long)BLOCKS_PER_SM * sms;
  void* args[] = {(void*)&a};
  return (int)cudaLaunchKernel((const void*)kernel, dim3((unsigned)blocks),
                               dim3(THREADS), args, smem, st);
}

// the 3 x 3 windows with the next party's row in flight; 5 x 5 too where
// two rows fit the registers (4-byte loads)
template <int V>
int launch_all(const Args& a, size_t smem, cudaStream_t st) {
  if (a.K == 9)
    return launch_rows(party_walk_kernel<9, V, true>, a, V, smem, st);
  if (a.K == 25)
    return launch_rows(party_walk_kernel<25, V, V == 1>, a, V, smem, st);
  return launch_rows(party_walk_any_kernel<V>, a, V, smem, st);
}

__global__ void __launch_bounds__(OLD_THREADS)
per_party_kernel(const uint32_t* __restrict__ x,
                 const uint32_t* __restrict__ wf,
                 const uint32_t* __restrict__ ws,
                 uint32_t* __restrict__ z,
                 int S, int C, long long M, int K, int N,
                 long long sxs, long long sxc, long long sxm,
                 long long sxk, long long szs, long long szc,
                 long long szm, long long szn) {
  extern __shared__ uint32_t wsh[];  // [wf_p slab | ws_p slab], (C, K, N)
  const int p = blockIdx.y;
  const int pn = (p + 1) % S;
  const int ckn = C * K * N;
  for (int e = threadIdx.x; e < ckn; e += blockDim.x) {
    wsh[e] = wf[(long long)p * ckn + e];
    wsh[ckn + e] = ws[(long long)p * ckn + e];
  }
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
    const uint32_t* xo = x + p * sxs + c * sxc + m * sxm;
    const uint32_t* xn = x + pn * sxs + c * sxc + m * sxm;
    const uint32_t* wfc = wsh + c * K * N;
    const uint32_t* wsc = wsh + ckn + c * K * N;
    uint32_t* zo = z + p * szs + c * szc + m * szm;
    for (int n = 0; n < N; ++n) {
      uint32_t acc = 0u;
      for (int k = 0; k < K; ++k)
        acc += xo[k * sxk] * wfc[k * N + n] + xn[k * sxk] * wsc[k * N + n];
      zo[n * szn] = acc;
    }
  }
}

}  // namespace

// x: (S, C, M, K) with element strides sx*; wf / ws: contiguous (S, C, K, N);
// z: (S, C, M, N) with element strides sz*.  mode 0: party_walk_kernel
// (8·S·C·K·N bytes of shared memory, up to the card's opt-in limit); 1: the
// first design, per_party_kernel (8·C·K·N bytes, within the 48 KB default).
extern "C" int grouped_rss_matmul_launch(
    const void* x, const void* wf, const void* ws, void* z, int S, int C,
    long long M, int K, int N, long long sxs, long long sxc, long long sxm,
    long long sxk, long long szs, long long szc, long long szm, long long szn,
    int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 1) {
    const size_t smem = 2 * (size_t)C * K * N * sizeof(uint32_t);
    if (smem > SMEM_DEFAULT) return (int)cudaErrorInvalidValue;
    const long long total = M * C;
    long long blocks = (total + OLD_THREADS - 1) / OLD_THREADS;
    if (blocks > OLD_MAX_BLOCKS) blocks = OLD_MAX_BLOCKS;
    per_party_kernel<<<dim3((unsigned)blocks, (unsigned)S), OLD_THREADS,
                       smem, st>>>(
        (const uint32_t*)x, (const uint32_t*)wf, (const uint32_t*)ws,
        (uint32_t*)z, S, C, M, K, N, sxs, sxc, sxm, sxk, szs, szc, szm, szn);
    return (int)cudaGetLastError();
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  // refused by cudaFuncSetAttribute past the card's opt-in limit
  const size_t smem = 2 * (size_t)S * C * K * N * sizeof(uint32_t);
  Args a{(const uint32_t*)x, (const uint32_t*)wf, (const uint32_t*)ws,
         (uint32_t*)z, S, C, K, N, M, sxs, sxc, sxm, sxk, szs, szc, szm, szn,
         sxc <= sxm, false};
  const bool vec = a.c_fast && sxc == 1 && C % 4 == 0 && sxm % 4 == 0
      && sxk % 4 == 0 && sxs % 4 == 0 && (uintptr_t)x % 16 == 0;
  a.vec_z = vec && szc == 1 && szm % 4 == 0 && szs % 4 == 0
      && (N == 1 || szn % 4 == 0) && (uintptr_t)z % 16 == 0;
  return vec ? launch_all<4>(a, smem, st) : launch_all<1>(a, smem, st);
}
