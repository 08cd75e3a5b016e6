// Device helpers shared by the selective scan's forward kernel
// (mamba_scan.cu) and its backward kernel (mamba_scan_bwd.cu): the
// chunk length of the saved states, element conversions, the
// exponential, the producer warp's tile copies and the reductions over
// the lanes of a channel or over the channels of a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace scan {

// The forward kernel can save the state at the start of every chunk of
// CHUNK steps, (Bt, ceil(S / CHUNK), D, NP) fp32; the backward kernel
// recomputes each chunk's states from it (mamba_scan_bwd.cu says why 16).
constexpr int CHUNK = 16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename E>
__device__ __forceinline__ E zero() {
  return E(0.f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// 2^x as one MUFU.EX2; subnormal inputs and results flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The mbarrier's current phase also waits for this thread's cp.async
// copies issued so far (the pending count is raised now and lowered when
// they land); the thread still arrives itself.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

// One operand's time tile into shared memory as [rows][W]: row r is
// global row `row0 + r` (of pitch `ld` elements) from column `c0`; zeros
// past `valid_rows` rows and past column `cols`. 16-byte copies when
// `vec` (the rows are 16-byte aligned), else element by element.
template <int W, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src,
                                          long long row0, int rows,
                                          int valid_rows, int ld, int c0,
                                          int cols, bool vec, int lane) {
  if (vec) {
    constexpr int V = 16 / sizeof(E);
    constexpr int CW = W / V;  // 16-byte chunks a row
    for (int i = lane; i < rows * CW; i += 32) {
      const int r = i / CW, q = i % CW;
      const int n = r < valid_rows ? min(max(cols - c0 - q * V, 0), V) : 0;
      const E* s = n ? src + (row0 + r) * ld + c0 + q * V : src;
      cp_async16(sm90::smem_u32(dst + r * W + q * V), s, n * (int)sizeof(E));
    }
  } else {
    for (int i = lane; i < rows * W; i += 32) {
      const int r = i / W, c = i % W;
      dst[i] = (r < valid_rows && c0 + c < cols) ? src[(row0 + r) * ld + c0 + c]
                                                 : zero<E>();
    }
  }
}

// Sums p (one partial a step, for G steps) over the G lanes of a channel
// and returns the sum of step g to lane g: log2(G) rounds, each halving
// the steps a lane holds. The order of every addition is fixed.
template <int G>
__device__ __forceinline__ float reduce_scatter(float (&p)[G], int g) {
#pragma unroll
  for (int m = G / 2; m >= 1; m /= 2) {
    const bool hi = g & m;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = hi ? p[i] : p[i + m];
      const float keep = hi ? p[i + m] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return p[0];
}

// Sums v (V values a lane) over the 32 / G lanes of a warp that share
// g = lane % G, one lane a channel: halving rounds over the xor masks 16,
// 8, ..., G while a lane holds two values or more, then butterfly rounds,
// every addition in a fixed order. Afterwards v[0 .. K-1], K = max(V G /
// 32, 1), hold the sums of values first .. first + K - 1; returns first,
// or -1 on a lane whose sums another lane (of lower index) also holds.
template <int G, int V>
__device__ __forceinline__ int reduce_channels(float (&v)[V], int lane) {
  constexpr int COPIES = (32 / V - 1) & ~(G - 1);  // the butterfly masks
  int first = 0;
#pragma unroll
  for (int m = 16; m >= G; m /= 2) {
    const int n = V * m / 16;  // values a lane holds before this round
    if (n >= 2) {
      const bool hi = lane & m;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = hi ? v[i] : v[i + n / 2];
        const float keep = hi ? v[i + n / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
      if (hi) first += n / 2;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
    }
  }
  return (lane & COPIES) ? -1 : first;
}

}  // namespace scan
