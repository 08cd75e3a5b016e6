// STREAM triad a = b + alpha * c over n contiguous elements, fp32 or bf16.
//
// Replaces the TPU kernel `_triad_kernel` / `triad_pallas`
// (src/repro/kernels/stream_triad.py:21,27), which streams (256, 512)
// tiles through VMEM. Here there is no tile: the array is one flat run of
// elements and a grid-stride loop walks it.
//
// Rounding, the Pallas kernel's:
//   * fp32: one rounding, a = fma(alpha, c, b) with alpha rounded to fp32
//     (XLA contracts the kernel body into an FMA). `__fmaf_rn`.
//   * bf16: alpha rounded to bf16 first, then the product rounded to bf16
//     and the sum rounded to bf16. Each op is done in fp32 with an explicit
//     `_rn` intrinsic and rounded once to bf16: the product of two bf16
//     values is exact in fp32, and an fp32 sum rounded to bf16 is the
//     correctly rounded bf16 sum (24 >= 2 * 8 + 2 bits), so this is the
//     bf16 product and sum, as PyTorch's plain bf16 ops compute them.
// The explicit intrinsics keep nvcc's --fmad=true from changing either.
//
// What bounds it on an H100: bytes. Per element it reads b and c and
// writes a, 3 x 4 bytes in fp32, for one FMA: 0.17 flop a byte, far below
// the 20 of the card's fp32 peak over its memory rate. At (32768, 32768)
// fp32 that is 12.9 GB, 3.85 ms at 3.35 TB/s.
//
// What the design does about it:
//   * 16-byte vector loads and stores (4 fp32 or 8 bf16 a thread), each
//     warp on 512 consecutive bytes, when all three pointers are 16-byte
//     aligned; a scalar tail for the last n % 4 (or % 8) elements.
//   * A grid-stride loop over a grid that covers the array: one vector a
//     thread, so each block streams one contiguous 4 KB run of each array
//     and the card always has every resident block's loads in flight. (On
//     the H100 this ran as fast as torch.add, where a grid of 8 blocks per
//     SM striding over the whole array ran slower, by an amount that moved
//     with where the arrays lay in memory.)
//   * 64-bit indices: 2^31 elements and more.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 0x7FFFFFFF;  // grid.x limit; the loop covers the rest

__device__ __forceinline__ float triad1(float b, float c, float alpha) {
  return __fmaf_rn(alpha, c, b);
}
__device__ __forceinline__ __nv_bfloat16 triad1(__nv_bfloat16 b,
                                                __nv_bfloat16 c,
                                                float alpha) {
  // alpha arrives already rounded to bf16 (exact in fp32)
  const __nv_bfloat16 p =
      __float2bfloat16_rn(__fmul_rn(alpha, __bfloat162float(c)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(b), __bfloat162float(p)));
}

template <typename T>
__device__ __forceinline__ uint4 triad_vec(uint4 vb, uint4 vc, float alpha) {
  constexpr int V = 16 / sizeof(T);
  uint4 va;
  const T* pb = reinterpret_cast<const T*>(&vb);
  const T* pc = reinterpret_cast<const T*>(&vc);
  T* pa = reinterpret_cast<T*>(&va);
#pragma unroll
  for (int k = 0; k < V; ++k) pa[k] = triad1(pb[k], pc[k], alpha);
  return va;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
triad(const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ a,
      float alpha, int64_t n, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  const uint4* vc = reinterpret_cast<const uint4*>(c);
  uint4* va = reinterpret_cast<uint4*>(a);
  for (int64_t i = tid; i < nvec; i += stride)
    va[i] = triad_vec<T>(vb[i], vc[i], alpha);
  for (int64_t i = nvec * V + tid; i < n; i += stride)
    a[i] = triad1(b[i], c[i], alpha);
}

template <typename T>
cudaError_t launch(const void* b, const void* c, void* a, float alpha,
                   int64_t n, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) % 16) == 0;
  const int64_t nvec = aligned ? n / V : 0;
  const int64_t work = nvec > 0 ? nvec : n;  // the tail is < V elements
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  triad<T><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(a),
      alpha, n, nvec);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller has
// checked devices, dtypes, equal shapes, contiguity and n > 0; alpha is
// already rounded to fp32 (and, for bf16, to bf16).
extern "C" int repro_triad(const void* b, const void* c, void* a, float alpha,
                           int64_t n, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(b, c, a, alpha, n, s);
  return launch<float>(b, c, a, alpha, n, s);
}
