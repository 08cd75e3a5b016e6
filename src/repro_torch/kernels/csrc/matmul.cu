// C = A @ B with fp32 accumulation, output in A's dtype, for bf16 and fp32.
//
// Replaces the TPU kernel `_matmul_kernel` / `matmul_pallas`
// (src/repro/kernels/matmul.py:24,40), which streams (256x512)x(512x256)
// panels through VMEM and keeps the fp32 accumulator resident across K.
//
// Four routes, chosen by the wrapper (kernels/matmul.py `route`) from the
// shape, the dtype and the pointers' alignment, before the launch:
//   * wgmma (bf16, M >= 64, B as (K, N), K and N multiples of 8, all
//     pointers 16-byte aligned): every prefill projection. Bound by the
//     tensor cores (989 TFLOP/s dense bf16; M = 4096 gives K*N*8 flops for
//     K*N*2 bytes of weights). Only wgmma reaches that rate, and only if
//     loads never stall it and shared memory can feed it, so: 128x256
//     output tiles (128x128 where that takes fewer waves over the SMs,
//     chosen by the wrapper), two consumer warpgroups of 64 rows issuing
//     wgmma.m64n256k16 (or n128) on shared-memory operands with one k-tile
//     still in flight; a producer warpgroup whose one thread keeps TMA
//     loads of 128x64 A and 64xBN B tiles in flight in a ring of 4 (or 6)
//     slots, each with a "full" mbarrier (bytes landed) and an "empty" one
//     (both consumers' wgmma on it retired); setmaxnreg moves registers
//     from the producer to the consumers. TMA writes the 128-byte swizzle
//     that wgmma reads, and zero-fills rows and columns past M, N and K,
//     so ragged tails need no code in the loop. B (K, N) is N-major, read
//     with wgmma's transpose-B bit. The epilogue stages the tile in shared
//     memory and stores whole 16-byte chunks of rows. Tiles are walked in
//     groups of GROUP_M M-tiles, so the blocks in flight share A and B
//     panels in L2.
//   * decode (bf16, M <= 16): the decode projections run at M = 4 (the
//     batch), so a weight byte serves 16 flops at most and the route is
//     bound by reading B from HBM once (3.35 TB/s). By Little's law that
//     takes about 3.3 MB in flight (1 us of latency x 3.35 TB/s), 25 KB
//     an SM. `matmul_decode`: a block takes one tile of C's columns and
//     one slice of K. Tiles are 32 columns wide, or 64 for weights of 32
//     MiB and more, whose long streams gain more from 128-byte rows than
//     from more tiles (`decode_tile_n` in the wrapper). Split-K
//     (`decode_split`) cuts K into as many slices as give about two
//     blocks an SM where the tiles alone give fewer than one (x_proj, N =
//     288: 26 slices; the LM heads: 1). Each block streams its slice
//     through a ring of 64-deep K-steps, 7 steps (28 KB of B; 64 wide, 5
//     and 40 KB) in flight, by 16-byte cp.async with zero-fill, B's lines
//     marked evict-first in the L2. Not TMA: decode operands need not be
//     16-byte aligned (K = 8190, odd N, a sliced A), and a misaligned
//     operand is staged element by element into the same ring. Four
//     warps each take 16 k of every 64 on the tensor cores (at M = 16,
//     FMA on the CUDA cores would need 80 % of their rate): mma.sync
//     m16n8k16 with A's rows past M read from a row of zeros, fragments
//     by ldmatrix, .trans for B as (K, N); the tied LM head's (N, K)
//     table is read in place (`b_transposed`). A tile's slices leave fp32
//     partials in a workspace; the last block to arrive (a per-tile
//     counter: __threadfence, atomicAdd) sums them in slice order, rounds
//     once to bf16 and resets the counter to 0, in the same launch. So
//     the output is bit-identical from call to call and needs no memset.
//   * mma_sync (bf16 shapes the wgmma route does not take: 16 < M < 64,
//     rows not 16-byte aligned, B as (N, K)): 128x128 tiles, 8 warps of
//     64x32 with mma.sync m16n8k16, one shared-memory stage, 16-byte
//     loads where aligned, zero-fill and masked stores for any M, N, K.
//   * f32: 64x64 tiles of fmaf on the CUDA cores, so it never uses TF32.
// Not yet: a persistent grid or stream-K for the wgmma route's shapes
// with few tiles (x_proj, N = 288: 96 tiles on 132 SMs; N = 1152), whose
// epilogue would overlap the next tile's loads, with clusters sharing A
// and B tiles by TMA multicast.
#include "mma_bf16.cuh"
#include "sm90.cuh"

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

// ---------------------------------------------------------------- decode

namespace dec {
constexpr int BK = 64;               // the K-step: one slot of the ring
constexpr int THREADS = 128;         // 4 warps: warp w takes k 16w..16w+15
constexpr int WARPS = THREADS / 32;  //   of every 64 of a step
// bf16 row pitches (A's, and B's below) padded by 16 bytes, so that the 8
// rows of one ldmatrix phase fall in 8 different bank groups
constexpr int A_LD = BK + 8;
constexpr int A_BYTES = 16 * A_LD * 2;
constexpr int RED_BATCH = 16;        // partials a thread loads at once
// ring slots for a tile BN wide (32 or 64): STAGES - 1 steps in flight,
// 28 or 40 KB of B; 58 or 68 KB of shared memory, 3 blocks an SM
__host__ __device__ constexpr int stages(int bn) { return bn == 32 ? 8 : 6; }
// B's slot: Bs[n][k] when B is given as (N, K), else Bs[k][n]
__host__ __device__ constexpr int b_ld(int bn, bool bt) {
  return bt ? A_LD : bn + 8;
}
__host__ __device__ constexpr int stage_bytes(int bn, bool bt) {
  return A_BYTES + (bt ? bn : BK) * b_ld(bn, bt) * 2;
}
__host__ __device__ constexpr int smem_bytes(int bn, bool bt) {
  return stages(bn) * stage_bytes(bn, bt) + 16;  // + one row of zeros for A
}
}  // namespace dec

// 8 bf16 at src into shared memory at dst, zeros past the first n (n may
// be <= 0 or > 8): one cp.async where `vec` says the operand's rows are
// 16-byte aligned (`base` stands in for src when nothing is read), with
// the L2 `policy` when STREAM; else element by element.
template <bool STREAM = false>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n,
                                       bool vec, const bf16* base,
                                       uint64_t policy = 0) {
  n = max(0, min(n, 8));
  if (vec) {
    if constexpr (STREAM)
      cp_async16_hint(sm90::smem_u32(dst), n ? src : base, 2 * n, policy);
    else
      cp_async16(sm90::smem_u32(dst), n ? src : base, 2 * n);
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = e < n ? src[e] : __float2bfloat16_rn(0.f);
}

// C (M <= 16, N) = A @ B for one BN-column tile (blockIdx.x) and one K-slice
// (blockIdx.y of gridDim.y, each ceil(steps / slices) K-steps long, the
// last shorter). With one slice the block writes C; with more, each writes
// its fp32 partial to ws[slice][M][N], and the last of the tile's blocks
// to arrive sums the partials in slice order into C and resets the tile's
// counter in `arrivals` to 0.
template <int BN, bool BT>
__global__ void __launch_bounds__(dec::THREADS)
matmul_decode(const bf16* __restrict__ A, const bf16* __restrict__ B,
              bf16* __restrict__ C, float* __restrict__ ws,
              int* __restrict__ arrivals, int M, int N, int K) {
  using namespace dec;
  constexpr int STAGES = stages(BN), B_LD = b_ld(BN, BT);
  constexpr int STAGE = stage_bytes(BN, BT);
  constexpr int NG = BN / 8;          // mma n-groups of the tile
  constexpr int RED_LD = BN + 1;      // fp32 pitch of the warps' partials
  static_assert(BK % (16 * WARPS) == 0 && BN % 16 == 0 && THREADS % BN == 0,
                "tiling");
  static_assert(WARPS * 16 * RED_LD * 4 <= STAGES * STAGE,
                "the warps' partial tiles reuse the ring");
  extern __shared__ __align__(16) uint8_t dec_smem[];
  __shared__ int last;
  const uint32_t ring = sm90::smem_u32(dec_smem);
  const uint32_t zero_row = ring + STAGES * STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, S = gridDim.y;
  const int per = ((K + BK - 1) / BK + S - 1) / S * BK;  // a slice's k
  const int k_begin = blockIdx.y * per, k_end = min(K, k_begin + per);
  const int steps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int ldb = BT ? K : N;
  const bool a_vec =
      ((reinterpret_cast<uintptr_t>(A) | (uintptr_t)K * 2) & 15) == 0;
  const bool b_vec =
      ((reinterpret_cast<uintptr_t>(B) | (uintptr_t)ldb * 2) & 15) == 0;
  uint64_t policy;  // B is read once: its lines leave the L2 first
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  if (tid < 4) reinterpret_cast<uint32_t*>(dec_smem + STAGES * STAGE)[tid] = 0;

  auto load = [&](int i) {  // step i of the slice into slot i % STAGES
    bf16* As = reinterpret_cast<bf16*>(dec_smem + (i % STAGES) * STAGE);
    bf16* Bs = As + A_BYTES / 2;
    const int k0 = k_begin + i * BK;
    for (int v = tid; v < M * (BK / 8); v += THREADS) {  // A's rows below M
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      stage8(As + r * A_LD + c, A + (size_t)r * K + k0 + c, k_end - k0 - c,
             a_vec, A);
    }
#pragma unroll
    for (int j = 0; j < BN * BK / 8 / THREADS; ++j) {
      const int v = tid + j * THREADS;
      if constexpr (BT) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8, gn = n0 + r;
        stage8<true>(Bs + r * B_LD + c, B + (size_t)gn * K + k0 + c,
                            gn < N ? k_end - k0 - c : 0, b_vec, B, policy);
      } else {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8, gk = k0 + r;
        stage8<true>(Bs + r * B_LD + c, B + (size_t)gk * N + n0 + c,
                            gk < k_end ? N - n0 - c : 0, b_vec, B, policy);
      }
    }
  };

  // ldmatrix addresses: lane l gives row l % 8 of matrix q = l / 8
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = r8 + (q & 1) * 8;  // A: (rows 0-7 | 8-15) x (k | k+8)
  float acc[NG][4] = {};
  auto mma_step = [&](int slot) {
    const uint32_t as = ring + slot * STAGE, bs = as + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / (16 * WARPS); ++ks) {
      const int kk = 16 * (ks * WARPS + warp);
      uint32_t a[4], b[NG][2];
      ldmatrix_x4(a, a_row < M ? as + (a_row * A_LD + kk + (q >> 1) * 8) * 2
                               : zero_row);
#pragma unroll
      for (int h = 0; h < NG / 2; ++h) {  // columns 16h..16h+15
        uint32_t x[4];
        if constexpr (BT)
          ldmatrix_x4(x, bs + ((16 * h + (q >> 1) * 8 + r8) * B_LD + kk +
                               (q & 1) * 8) * 2);
        else
          ldmatrix_x4_trans(x, bs + ((kk + (q & 1) * 8 + r8) * B_LD +
                                     16 * h + (q >> 1) * 8) * 2);
        b[2 * h][0] = x[0];
        b[2 * h][1] = x[1];
        b[2 * h + 1][0] = x[2];
        b[2 * h + 1][1] = x[3];
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) mma_bf16_16816(acc[j], a, b[j]);
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<STAGES - 2>();  // step i has landed
    __syncthreads();              // ...for every thread; slot i - 1 is free
    if (i + STAGES - 1 < steps) load(i + STAGES - 1);
    cp_async_commit();
    mma_step(i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's tile: the warps' partial tiles summed in warp order
  float* red = reinterpret_cast<float*>(dec_smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 16 + g + 8 * (e >> 1)) * RED_LD + 8 * j + 2 * t + (e & 1)] =
          acc[j][e];
  __syncthreads();
  // a thread's outputs: rows tid / BN + o * (THREADS / BN), column col
  constexpr int OUT = 16 * BN / THREADS;
  const int col = tid % BN, n = n0 + col;
  float sum[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int m = (tid + o * THREADS) / BN;
    sum[o] = red[m * RED_LD + col];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) sum[o] += red[(16 * w + m) * RED_LD + col];
  }
  if (S == 1) {
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      const int m = (tid + o * THREADS) / BN;
      if (m < M && n < N) C[(size_t)m * N + n] = __float2bfloat16_rn(sum[o]);
    }
    return;
  }
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int m = (tid + o * THREADS) / BN;
    if (m < M && n < N) ws[((size_t)blockIdx.y * M + m) * N + n] = sum[o];
  }
  // Arrive: the block's partial (ordered before thread 0's fence by the
  // barrier) is visible device-wide before its count is.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&arrivals[blockIdx.x], 1) == S - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    const int m = (tid + o * THREADS) / BN;
    if (m >= M || n >= N) continue;
    const float* p = ws + (size_t)m * N + n;
    const size_t step = (size_t)M * N;
    float s = 0.f;
    for (int p0 = 0; p0 < S; p0 += RED_BATCH) {  // in slice order
      float v[RED_BATCH];
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u)
        v[u] = p0 + u < S ? __ldcg(p + (p0 + u) * step) : 0.f;
#pragma unroll
      for (int u = 0; u < RED_BATCH; ++u) s += v[u];
    }
    C[(size_t)m * N + n] = __float2bfloat16_rn(s);
  }
  if (tid == 0) arrivals[blockIdx.x] = 0;  // ready for the next launch
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

// ---------------------------------------------------------------- wgmma

namespace wg {
constexpr int BM = 128, BK = 64;       // BK * 2 bytes = the 128-byte swizzle
constexpr int THREADS = 384;           // a producer and two consumer warpgroups
constexpr int GROUP_M = 16;            // M-tiles walked together over N
constexpr int A_BYTES = BM * BK * 2;   // 16 KB: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;     // 8 KB: 64 k-rows of 64 columns
// ring slots: 4 x 48 KB for 128x256 tiles, 6 x 32 KB for 128x128
__host__ __device__ constexpr int stages(int bn) { return bn == 256 ? 4 : 6; }
__host__ __device__ constexpr int smem_bytes(int bn) {
  return stages(bn) * (A_BYTES + bn / 64 * B_BOX) + 1024;  // + room to align
}
}  // namespace wg

// One 128xBN tile of C per block. Warpgroup 0 produces: one thread keeps
// the ring full with TMA loads, each slot's "full" mbarrier counting the
// bytes in, its "empty" one counting the consumers out. Warpgroups 1 and 2
// consume 64 rows each with wgmma, keeping one k-tile's wgmma in flight
// while they issue the next; registers move from producer to consumers
// with setmaxnreg.
template <int BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul_wgmma(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, bf16* __restrict__ C,
             int M, int N, int K) {
  using namespace wg;
  constexpr int STAGES = stages(BN);
  constexpr int STAGE_BYTES = A_BYTES + BN / 64 * B_BOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / group) * GROUP_M;
  const int rows_m = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (blockIdx.x % group) % rows_m) * BM;
  const int n0 = ((blockIdx.x % group) / rows_m) * BN;
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        uint8_t* a = smem + s * STAGE_BYTES;
        if (kt >= STAGES)  // the slot's previous k-tile has retired
          sm90::mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        sm90::tma_load_2d(a, &ta, &full[s], kt * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          sm90::tma_load_2d(a + A_BYTES + j * B_BOX, &tb, &full[s],
                            n0 + 64 * j, kt * BK);
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<232>();
  const int w = tid / 128 - 1, t = tid % 128;  // consumer warpgroup, thread

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
    __syncwarp();
    const uint32_t a_base =
        sm90::smem_u32(smem + s * STAGE_BYTES) + w * (64 * BK * 2);
    const uint32_t b_base = sm90::smem_u32(smem + s * STAGE_BYTES + A_BYTES);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // A: 32 bytes along the row; B: 16 k-rows
      sm90::wgmma_m64k16<BN, 1>(
          acc, sm90::desc_sw128(a_base + kk * 32, 16, 1024),
          sm90::desc_sw128(b_base + kk * 16 * 128, B_BOX, 1024));
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // the previous k-tile's wgmma has retired
    sm90::fence_regs(acc);
    if (t == 0 && kt > 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // Epilogue through shared memory, so that each row leaves in 16-byte
  // stores; masked on M and N (N is a multiple of 8 on this route, so a
  // 16-byte chunk never straddles it).
  constexpr int P = BN + 8;  // row pitch in bf16: rows land 4 banks apart
  bf16* tile = reinterpret_cast<bf16*>(smem) + w * 64 * P;
  const int lane = t % 32, r0 = (t / 32) * 16 + lane / 4;
  sm90::bar_sync(1, 256);  // both consumers are done with the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8 * h) * P + j * 8 +
                                         2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  sm90::bar_sync(2 + w, 128);
#pragma unroll 4
  for (int c = t; c < 64 * BN / 8; c += 128) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int row = m0 + w * 64 + r, col = n0 + cc;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(C + (size_t)row * N + col) =
          *reinterpret_cast<const uint4*>(tile + r * P + cc);
  }
}

// A 2-D row-major bf16 tensor of `rows` x `cols` read in boxes of
// box_rows x box_cols, 128-byte swizzled, zeros past the edge.
CUresult encode_2d(CUtensorMap* map, const void* ptr, uint64_t rows,
                   uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return sm90::encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                     const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int BN>
int launch_wgmma_tile(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                      int M, int N, int K, cudaStream_t s) {
  static bool sized = false;  // once per tile width
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(matmul_wgmma<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg::smem_bytes(BN));
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long tiles =
      (long long)((M + wg::BM - 1) / wg::BM) * ((N + BN - 1) / BN);
  if (tiles > INT32_MAX) return cudaErrorInvalidConfiguration;
  matmul_wgmma<BN><<<(unsigned)tiles, wg::THREADS, wg::smem_bytes(BN), s>>>(
      ta, tb, static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

// Returns a cudaError_t, or -(CUresult) when a tensor map cannot be made.
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                 int tile_n, cudaStream_t s) {
  if (tile_n != 128 && tile_n != 256) return cudaErrorInvalidValue;
  if (!sm90::encode_fn()) return cudaErrorNotSupported;
  CUtensorMap ta, tb;
  CUresult r = encode_2d(&ta, a, M, K, wg::BM, wg::BK);
  if (r == CUDA_SUCCESS) r = encode_2d(&tb, b, K, N, wg::BK, 64);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  return tile_n == 256 ? launch_wgmma_tile<256>(ta, tb, c, M, N, K, s)
                       : launch_wgmma_tile<128>(ta, tb, c, M, N, K, s);
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

template <int BN, bool BT>
int launch_decode_tile(const void* a, const void* b, void* c, int M, int N,
                       int K, int split, float* ws, int* arrivals,
                       cudaStream_t s) {
  constexpr int smem = dec::smem_bytes(BN, BT);
  static bool sized = false;  // once per instance
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        matmul_decode<BN, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e == cudaSuccess)  // room for several blocks an SM
      e = cudaFuncSetAttribute(matmul_decode<BN, BT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((N + BN - 1) / BN, split);
  matmul_decode<BN, BT><<<grid, dec::THREADS, smem, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), ws, arrivals, M, N, K);
  return cudaGetLastError();
}

template <bool BT>
int launch_decode(const void* a, const void* b, void* c, int M, int N, int K,
                  int tile_n, int split, float* ws, int* arrivals,
                  cudaStream_t s) {
  if (M > 16 || split < 1 || split > 65535 || (split > 1 && !(ws && arrivals)))
    return cudaErrorInvalidValue;
  switch (tile_n) {
    case 32:
      return launch_decode_tile<32, BT>(a, b, c, M, N, K, split, ws, arrivals, s);
    case 64:
      return launch_decode_tile<64, BT>(a, b, c, M, N, K, split, ws, arrivals, s);
  }
  return cudaErrorInvalidValue;
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

// Launches the route the caller chose (kernels/matmul.py ROUTES: 0 f32,
// 1 decode in `split` K-slices, 2 mma_sync, 3 wgmma with tiles `tile_n`
// columns wide) and returns the cudaError_t of the launch (0 on success),
// or -(CUresult) when a TMA tensor map cannot be made. The caller has
// checked shapes, dtypes, contiguity, M, N > 0 and that the route takes
// the operands; a split decode needs `ws` (split x M x N fp32) and
// `arrivals` (one zeroed int per 32 columns, left zeroed).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int b_transposed, int route,
                            int tile_n, int split, float* ws, int* arrivals,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return b_transposed ? launch_f32<true>(a, b, c, M, N, K, s)
                          : launch_f32<false>(a, b, c, M, N, K, s);
    case 1:
      return b_transposed ? launch_decode<true>(a, b, c, M, N, K, tile_n,
                                                split, ws, arrivals, s)
                          : launch_decode<false>(a, b, c, M, N, K, tile_n,
                                                 split, ws, arrivals, s);
    case 2:
      return b_transposed
                 ? launch_bf16<128, 128, 32, 2, 4, true>(a, b, c, M, N, K, s)
                 : launch_bf16<128, 128, 32, 2, 4, false>(a, b, c, M, N, K, s);
    case 3:
      if (b_transposed) return cudaErrorInvalidValue;
      return launch_wgmma(a, b, c, M, N, K, tile_n, s);
  }
  return cudaErrorInvalidValue;
}
