// C = A @ B with fp32 accumulation, output in A's dtype, for bf16 and fp32.
//
// Replaces the TPU kernel `_matmul_kernel` / `matmul_pallas`
// (src/repro/kernels/matmul.py:24,40), which streams (256x512)x(512x256)
// panels through VMEM and keeps the fp32 accumulator resident across K.
//
// What bounds it on an H100: the model's decode projections run at M = 4
// (the batch), so each weight byte is used for 8 flops at most; they are
// bound by reading B from HBM (3.35 TB/s), never by the tensor cores. The
// tied LM head reads the whole 262144x1152 embedding table (604 MB) per
// token. Prefill runs M = batch*prompt and is bound by the tensor cores
// (989 TFLOP/s bf16).
//
// What the design does about it:
//   * bf16 runs on the tensor cores through warp-level mma.sync m16n8k16
//     (bf16 in, fp32 accumulate); the fp32 path runs on the CUDA cores
//     with fmaf, so it never uses TF32.
//   * B may be given as (K, N) or as (N, K) row-major (`b_transposed`):
//     the LM head reads the embedding table in place instead of a
//     per-step transposed copy, which would add 604 MB of traffic.
//   * Small M (decode) takes a 16-row tile with a deep K step (128), so
//     each block keeps 8 KB of B in flight per step and blocks spread over
//     N; large M takes 128x128 tiles with 8 warps of 64x32 each.
//   * Any M, N, K: ragged tiles are zero-filled on load and masked on
//     store; loads are 16 bytes wide where the rows are 16-byte aligned.
// Not yet: TMA, wgmma, a multi-stage pipeline, split-K for the decode
// shapes whose N gives fewer blocks than the card has SMs.
#include "mma_bf16.cuh"

namespace {

constexpr int PAD = 8;  // bf16 row padding: keeps fragment loads free of bank conflicts

template <int BM, int BN, int BK, int WM, int WN, bool BT>
__global__ void __launch_bounds__(WM * WN * 32)
matmul_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
            bf16* __restrict__ C, int M, int N, int K) {
  constexpr int NT = WM * WN * 32;
  constexpr int TM = BM / WM, TN = BN / WN;  // one warp's output tile
  constexpr int MI = TM / 16, NI = TN / 8;
  // B tile: [BN][BK] when B is given as (N, K), else [BK][BN]
  constexpr int B_ROWS = BT ? BN : BK;
  constexpr int B_LD = (BT ? BK : BN) + PAD;
  __shared__ __align__(16) bf16 As[BM][BK + PAD];
  __shared__ __align__(16) bf16 Bs[B_ROWS][B_LD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ldb = BT ? K : N;
  const bool a_vec =
      ((reinterpret_cast<uintptr_t>(A) | (uintptr_t)K * 2) & 15) == 0;
  const bool b_vec =
      ((reinterpret_cast<uintptr_t>(B) | (uintptr_t)ldb * 2) & 15) == 0;

  float acc[MI][NI][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int v = tid; v < BM * BK / 8; v += NT) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      load8(&As[r][c], A + (size_t)gm * K + gk, gm < M ? K - gk : 0, a_vec);
    }
    if constexpr (BT) {
#pragma unroll
      for (int v = tid; v < BN * BK / 8; v += NT) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + c;
        load8(&Bs[r][c], B + (size_t)gn * K + gk, gn < N ? K - gk : 0,
              b_vec);
      }
    } else {
#pragma unroll
      for (int v = tid; v < BK * BN / 8; v += NT) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + c;
        load8(&Bs[r][c], B + (size_t)gk * N + gn, gk < K ? N - gn : 0,
              b_vec);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * TM + mi * 16 + g;
        af[mi][0] = ld_pair(&As[r][kk + 2 * t]);
        af[mi][1] = ld_pair(&As[r + 8][kk + 2 * t]);
        af[mi][2] = ld_pair(&As[r][kk + 2 * t + 8]);
        af[mi][3] = ld_pair(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn * TN + ni * 8 + g;
        if constexpr (BT) {
          bfr[ni][0] = ld_pair(&Bs[n][kk + 2 * t]);
          bfr[ni][1] = ld_pair(&Bs[n][kk + 2 * t + 8]);
        } else {
          bfr[ni][0] = pack_bf16(Bs[kk + 2 * t][n], Bs[kk + 2 * t + 1][n]);
          bfr[ni][1] =
              pack_bf16(Bs[kk + 2 * t + 8][n], Bs[kk + 2 * t + 9][n]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  const bool pairs = (N % 2) == 0;  // 4-byte aligned bf16 pairs
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = n0 + wn * TN + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * TM + mi * 16 + g + 8 * half;
        if (row >= M || col >= N) continue;
        const float x0 = acc[mi][ni][2 * half], x1 = acc[mi][ni][2 * half + 1];
        bf16* dst = C + (size_t)row * N + col;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16_rn(x0);
          if (col + 1 < N) dst[1] = __float2bfloat16_rn(x1);
        }
      }
    }
}

// fp32: 64x64 tiles, 256 threads of 4x4 outputs each, fmaf on the CUDA
// cores (no tensor cores, hence no TF32 rounding of the inputs).
template <bool BT>
__global__ void __launch_bounds__(256)
matmul_f32(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C, int M, int N, int K) {
  constexpr int T = 64, TK = 16;
  __shared__ float As[TK][T + 4];  // As[k][m]
  __shared__ float Bs[TK][T + 4];  // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < T * TK; i += 256) {
      const int r = i / TK, c = i % TK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      if constexpr (BT) {
        const int gn = n0 + r;
        Bs[c][r] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
      } else {
        const int kr = i / T, nc = i % T;
        const int gk2 = k0 + kr, gn = n0 + nc;
        Bs[kr][nc] = (gk2 < K && gn < N) ? B[(size_t)gk2 * N + gn] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty * 4 + i];
        b[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) C[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, bool BT>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int M, int N,
                        int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_bf16<BM, BN, BK, WM, WN, BT><<<grid, WM * WN * 32, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

template <bool BT>
cudaError_t launch_bf16_for(const void* a, const void* b, void* c, int M,
                            int N, int K, cudaStream_t s) {
  if (M <= 16)  // decode: one 16-row tile, deep K steps
    return launch_bf16<16, 32, 128, 1, 4, BT>(a, b, c, M, N, K, s);
  return launch_bf16<128, 128, 32, 2, 4, BT>(a, b, c, M, N, K, s);
}

template <bool BT>
cudaError_t launch_f32(const void* a, const void* b, void* c, int M, int N,
                       int K, cudaStream_t s) {
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  matmul_f32<BT><<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                      static_cast<const float*>(b),
                                      static_cast<float*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller has
// checked shapes, dtypes, contiguity and M, N > 0.
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int b_transposed, int is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return b_transposed ? launch_bf16_for<true>(a, b, c, M, N, K, s)
                        : launch_bf16_for<false>(a, b, c, M, N, K, s);
  return b_transposed ? launch_f32<true>(a, b, c, M, N, K, s)
                      : launch_f32<false>(a, b, c, M, N, K, s);
}
