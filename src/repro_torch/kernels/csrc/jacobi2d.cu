// One 5-point Jacobi sweep over an (R, C) row-major grid, fp32 or bf16:
// every interior cell becomes 0.2 * (self + above + below + left + right);
// the boundary rows and columns are copied through bit for bit (with R or
// C < 3 the whole grid is boundary).
//
// Replaces the TPU kernel `_jacobi_kernel` / `jacobi2d_pallas`
// (src/repro/kernels/jacobi2d.py:20,42), which walks row blocks whose
// height must divide R and takes its halo rows from clamped views of the
// neighbouring blocks. Here a thread owns one column of a strip of rows,
// and ragged edges are masked: any R and C.
//
// Rounding, the Pallas kernel's: the five values are summed in fp32 in the
// order mid, above, below, left, right (`__fadd_rn`), the sum is scaled
// by 0.2f (`__fmul_rn`), and the result is rounded once to the dtype. The
// explicit intrinsics keep nvcc's --fmad=true from contracting them.
//
// What bounds it on an H100: bytes. Each cell is read once and written
// once, 2 x 4 bytes in fp32, for 5 flops: at (32768, 32768) fp32 that is
// 8.6 GB, 2.56 ms at 3.35 TB/s.
//
// What the design does about it:
//   * A block is 256 threads across 256 columns and a strip of TR = 16
//     rows. Each thread first loads its column's 18 cells (the strip and
//     one halo row above and below) into registers, all 18 loads in
//     flight at once with no barrier, so a warp keeps many coalesced row
//     segments outstanding; the two halo rows re-read 2 of 16 rows, mostly
//     from L2.
//   * Left and right neighbours are loaded from global memory, for every
//     row of the strip whatever its place, so that these loads too are all
//     in flight at once; the warp's own column loads bring their lines
//     into L1.
//   * (On the H100 this ran faster, in both dtypes, than a 32 x 256 tile
//     staged in shared memory behind barriers; strips of 8 or 32 rows, or
//     neighbours passed by warp shuffle, ran slower.)
//   * 64-bit offsets; the grid covers the columns in x and strides over
//     strips in y, so any R is covered.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 256;  // columns per block, one a thread
constexpr int TR = 16;   // rows per strip
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TC)
jacobi2d(const T* __restrict__ in, T* __restrict__ out, int64_t R, int64_t C,
         int64_t strips) {
  const int64_t gc = (int64_t)blockIdx.x * TC + threadIdx.x;
  const bool live = gc < C;
  const int64_t cc = live ? gc : C - 1;  // past the edge: load, never store
  const bool col_inner = gc > 0 && gc < C - 1;
  for (int64_t t = blockIdx.y; t < strips; t += gridDim.y) {
    const int64_t r0 = t * TR;
    T col[TR + 2];  // rows r0 - 1 .. r0 + TR, clamped into the grid
#pragma unroll
    for (int k = 0; k < TR + 2; ++k) {
      int64_t r = r0 - 1 + k;
      r = r < 0 ? 0 : (r >= R ? R - 1 : r);
      col[k] = in[r * C + cc];
    }
#pragma unroll
    for (int k = 0; k < TR; ++k) {
      const int64_t r = r0 + k;
      if (r >= R) break;
      const float mid = to_f32(col[k + 1]);
      // left and right on every row, not only interior ones, and by every
      // thread before the edge test: loads that hang on neither can all be
      // issued ahead of the sums
      float left = 0.f, right = 0.f;
      if (col_inner) {
        left = to_f32(in[r * C + gc - 1]);
        right = to_f32(in[r * C + gc + 1]);
      }
      if (!live) continue;
      T* dst = out + r * C + gc;
      if (col_inner && r > 0 && r < R - 1) {
        float s = __fadd_rn(mid, to_f32(col[k]));
        s = __fadd_rn(s, to_f32(col[k + 2]));
        s = __fadd_rn(s, left);
        s = __fadd_rn(s, right);
        store(dst, __fmul_rn(0.2f, s));
      } else {
        *dst = col[k + 1];  // boundary: the input's bits
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, int64_t R, int64_t C,
                   cudaStream_t s) {
  const int64_t strips = (R + TR - 1) / TR;
  const dim3 grid((unsigned)((C + TC - 1) / TC),
                  (unsigned)(strips < MAX_GRID_Y ? strips : MAX_GRID_Y));
  jacobi2d<T><<<grid, TC, 0, s>>>(static_cast<const T*>(in),
                                  static_cast<T*>(out), R, C, strips);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller has
// checked the device, dtype, 2-D contiguity and R, C > 0.
extern "C" int repro_jacobi2d(const void* in, void* out, int64_t R, int64_t C,
                              int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(in, out, R, C, s);
  return launch<float>(in, out, R, C, s);
}
