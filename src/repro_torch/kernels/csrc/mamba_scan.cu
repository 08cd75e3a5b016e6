// Selective scan (Mamba-1) with an fp32 state, from h_0 = 0:
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t ;   y_t = h_t . C_t
// dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N); dt, A, B, C fp32; x and y
// bf16 or fp32 (y in x's dtype). Also writes h_last (Bt,D,N) fp32, the
// state after step S, which prefill hands to decode.
//
// Replaces the TPU kernel `_scan_kernel` / `mamba_scan_pallas`
// (src/repro/kernels/mamba_scan.py:27,51), which walks a sequential grid
// axis over 128-step chunks and carries h in VMEM scratch. Blocks of a
// CUDA grid run in no order, so the time loop moves inside the thread.
//
// What bounds it on an H100: per (b, t, d) it reads dt (4 B) and x and
// writes y (2 B each in bf16), and it evaluates N exponentials. At the
// falcon-mamba prefill shape (4, 1024, 8192, 16) that is 269 MB (0.080 ms
// at 3.35 TB/s) against 537 M exponentials: at 16 per clock per SM on the
// special-function units, 0.13 ms at 1.98 GHz. So the exponentials bound
// it, then the bytes, and the recurrence itself is a chain of N
// independent FMAs per step.
//
// What the design does about it:
//   * One thread owns one (batch, channel) pair and keeps its N states and
//     its row of A in registers for the whole sequence: no (Bt,S,D,N)
//     tensor, no state traffic to memory, one h_last write at the end.
//   * Blocks of 128 channels, a grid of (ceil(D/128), Bt): dt and x are
//     read, and y written, coalesced across the channels of a warp.
//   * Every channel of a block shares B_t and C_t, so a tile of 64 time
//     steps of both is staged in shared memory once per block and read as
//     broadcasts.
//   * N is padded to the next of 4, 8, 16, 32, 64 with A = B = C = 0, so
//     the padded states stay 0 without a branch; any S and D: the ragged
//     time tile and the channels past D are masked.
//   * The exponential is `expf`, the accurate one (not `__expf`), so the
//     kernel rounds like the plain version to a few ulp.
// Not yet: software-pipelined loads, N split over lanes, and a two-pass
// chunked scan that spreads one sequence over more threads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // channels per block
constexpr int TT = 64;        // time steps of B and C staged per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int NP, typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const T* __restrict__ x, T* __restrict__ y,
           float* __restrict__ h_last, int S, int D, int N) {
  __shared__ __align__(16) float sB[TT][NP];
  __shared__ __align__(16) float sC[TT][NP];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool active = d < D;

  float a[NP], h[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    a[n] = (active && n < N) ? A[(size_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float* Bb = Bm + (size_t)b * S * N;
  const float* Cb = Cm + (size_t)b * S * N;
  const size_t base = (size_t)b * S * D + d;

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int L = min(TT, S - t0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < TT * NP; i += THREADS) {
      const int r = i / NP, n = i % NP;
      const bool ok = r < L && n < N;
      const size_t off = (size_t)(t0 + r) * N + n;
      sB[r][n] = ok ? Bb[off] : 0.f;
      sC[r][n] = ok ? Cb[off] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int r = 0; r < L; ++r) {
      const size_t off = base + (size_t)(t0 + r) * D;
      const float dtv = dt[off];
      const float u = dtv * to_f32(x[off]);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + u * sB[r][n];
        acc += h[n] * sC[r][n];
      }
      store(y + off, acc);
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < NP; ++n)
      if (n < N) h_last[((size_t)b * D + d) * N + n] = h[n];
  }
}

template <int NP, typename T>
cudaError_t launch(const void* dt, const void* A, const void* B,
                   const void* C, const void* x, void* y, void* h_last,
                   int Bt, int S, int D, int N, cudaStream_t s) {
  const dim3 grid((D + THREADS - 1) / THREADS, Bt);
  mamba_scan<NP, T><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<float*>(h_last), S, D, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(const void* dt, const void* A, const void* B,
                       const void* C, const void* x, void* y, void* h_last,
                       int Bt, int S, int D, int N, cudaStream_t s) {
  if (N <= 4) return launch<4, T>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
  if (N <= 8) return launch<8, T>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
  if (N <= 16)
    return launch<16, T>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
  if (N <= 32)
    return launch<32, T>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
  return launch<64, T>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller has
// checked shapes, dtypes, contiguity, 1 <= N <= 64, Bt <= 65535 and
// Bt, D > 0.
extern "C" int repro_mamba_scan(const void* dt, const void* A, const void* B,
                                const void* C, const void* x, void* y,
                                void* h_last, int Bt, int S, int D, int N,
                                int x_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_for<__nv_bfloat16>(dt, A, B, C, x, y, h_last, Bt, S, D, N,
                                     s);
  return launch_for<float>(dt, A, B, C, x, y, h_last, Bt, S, D, N, s);
}
