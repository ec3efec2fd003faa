// Mamba-2 chunked SSD scan (Hopper, sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd.py::_ssd_kernel (pallas_call in
// ssd_scan).  x (B, S, H, hd), B and C (B, S, N) shared across heads, da
// and dt (B, S, H), all float32 -> y (B, S, H, hd) float32, contiguous.
// x, B and C are read with a unit last stride, da and dt through strides.
//
// The TPU kernel ran the chunks in order on the grid's last axis and kept
// the (hd, N) state in VMEM scratch between them.  Blocks on Hopper run in
// no order, so one block per (head, batch) loops over the chunks itself,
// with the state in shared memory for the whole sequence.  Per chunk of Q
// rows:
//   cum   = cumsum(da)                     (one thread, in order)
//   y_i   = exp(cum_i) * C_i state^T                     (carried state)
//         + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//   state = state * exp(cum_last)
//         + sum_j dt_j x_j exp(cum_last - cum_j) B_j^T
// At Q = 256 and N = 128 a chunk's B and C alone are 256 KB of float32,
// more than a block's 227 KB, so the chunk is cut into row blocks of
// R = min(Q, 64): for each output block I the kernel stages C_I and, for
// each J <= I, B_J (transposed, pitch R+1 so both its staging and its
// reads are free of bank conflicts) and x_J * dt_J, forms the (R, R)
// block of (C B^T) * decay in shared memory and adds its product with
// x_J * dt_J to y_I.  Shared memory: 4 * (N*hd + R*N + N*(R+1) + 2*R*hd
// + R*R + 2*Q) bytes, 150,016 at Mamba2-1.3B (hd 64, N 128, Q 256).
//
// What bounds it: at Mamba2-1.3B's layer shape the work is float32
// operations (~13 GFLOP at B 2, S 2048: the causal triangle of C B^T once
// per (batch, chunk), as B and C are shared across heads, and per head its
// decayed product with x and the state terms), 67 TFLOP/s on the CUDA
// cores.  This kernel forms C B^T again in every head's block.  Every FMA
// here reads its two operands from shared memory (one broadcast), so
// shared-memory issue bounds this first version; and at batch 1 there are
// only H = 64 blocks for 132 SMs (128 at batch 2).  A two-pass
// chunk-state scan (chunks in parallel, then a short pass over the
// states) and register tiles are the redesign.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(
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

  for (int i = tid; i < N * HD; i += THREADS) st[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();   // the previous chunk's state update is done
    for (int i = tid; i < Q; i += THREADS) {
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
      for (int idx = tid; idx < R * N; idx += THREADS) {
        const int i = idx / N, n = idx % N;
        ci[idx] = cb[(t0 + i0 + i) * scs + n];
      }
      __syncthreads();
      // carried-state term, from the state before this chunk
      for (int idx = tid; idx < R * HD; idx += THREADS) {
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
        for (int idx = tid; idx < R * N; idx += THREADS) {
          const int j = idx / N, n = idx % N;
          bt[n * (R + 1) + j] = bb[(t0 + j0 + j) * sbs + n];
        }
        for (int idx = tid; idx < R * HD; idx += THREADS) {
          const int j = idx / HD, d = idx % HD;
          xj[idx] = xb[(t0 + j0 + j) * sxs + d] * dts[j0 + j];
        }
        __syncthreads();
        for (int idx = tid; idx < R * R; idx += THREADS) {
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
        for (int idx = tid; idx < R * HD; idx += THREADS) {
          const int i = idx / HD, d = idx % HD;
          float acc = 0.f;
          for (int j = 0; j < R; ++j) acc = fmaf(mm[i * R + j],
                                                 xj[j * HD + d], acc);
          yi[idx] += acc;
        }
      }
      for (int idx = tid; idx < R * HD; idx += THREADS) {
        const int i = idx / HD, d = idx % HD;
        yb[(t0 + i0 + i) * ys + d] = yi[idx];
      }
      __syncthreads();   // ci and yi are reused by the next row block
    }

    // state update; each thread owns the same (n, d) entries throughout
    const float chunk_decay = expf(c_last);
    for (int idx = tid; idx < N * HD; idx += THREADS) st[idx] *= chunk_decay;
    for (int J = 0; J < nsub; ++J) {
      const int j0 = J * R;
      __syncthreads();
      for (int idx = tid; idx < R * N; idx += THREADS) {
        const int j = idx / N, n = idx % N;
        bt[n * (R + 1) + j] = bb[(t0 + j0 + j) * sbs + n];
      }
      for (int idx = tid; idx < R * HD; idx += THREADS) {
        const int j = idx / HD, d = idx % HD;
        xj[idx] = xb[(t0 + j0 + j) * sxs + d] * dts[j0 + j]
                  * expf(c_last - cum[j0 + j]);
      }
      __syncthreads();
      for (int idx = tid; idx < N * HD; idx += THREADS) {
        const int n = idx / HD, d = idx % HD;
        float acc = 0.f;
        for (int j = 0; j < R; ++j) acc = fmaf(xj[j * HD + d],
                                               bt[n * (R + 1) + j], acc);
        st[idx] += acc;
      }
    }
  }
}

}  // namespace

// Q = chunk (S % Q == 0), R = min(Q, 64) with Q % R == 0; smem = the bytes
// above (the wrapper checks them against the 227 KB a block may use).
extern "C" int ssd_scan_launch(
    const void* x, const void* bm, const void* cm, const void* da,
    const void* dt, void* y, int B, int S, int H, int HD, int N, int Q,
    int R, long long sxb, long long sxs, long long sxh, long long sbb,
    long long sbs, long long scb, long long scs, long long sdab,
    long long sdas, long long sdah, long long sdtb, long long sdts,
    long long sdth, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<<<dim3(H, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)bm, (const float*)cm, (const float*)da,
      (const float*)dt, (float*)y, S, H, HD, N, Q, R, sxb, sxs, sxh, sbb,
      sbs, scb, scs, sdab, sdas, sdah, sdtb, sdts, sdth);
  return (int)cudaGetLastError();
}
