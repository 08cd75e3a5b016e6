// Flash-attention backward, bf16 in and out, fp32 accumulation.
//
// No TPU kernel corresponds: the reference differentiates its attention
// (`_attend`, src/repro/models/attention.py) through XLA, and its Pallas
// flash kernel (src/repro/kernels/flash_attention.py) has no backward
// pass. This is the backward pass of the port's forward kernel
// (csrc/flash_attention.cu), from its output O and the fp32 row
// log-sum-exp it writes, in FlashAttention-2's form. With s = scale q.k
// and P = exp(s - lse) on the pairs the forward's mask leaves (top-left
// causal rule by index, a sliding window, keys < T):
//   dV = P^T dO (P rounded to bf16, as the forward rounds it before P.V),
//   Delta = rowsum(dO * O), dS = P * (dO V^T - Delta),
//   dQ = scale dS K, dK = scale dS^T Q,
// with dK and dV summed over the G = H / KV q heads of a KV head (GQA).
// kernels/ref.py `flash_attention_bwd_ref` states the same in fp32.
//
// Three launches on the caller's stream:
//   * flash_bwd_delta: Delta, one warp a row, a shuffle reduction.
//   * flash_bwd_dkv: one block of 4 warps per (batch, KV head, key tile).
//     It loops over the G q heads and over the query tiles that see its
//     keys, recomputes S^T = K Q^T and P^T, then dP^T = V dO^T, and
//     accumulates dV += P^T dO and dK += dS^T Q in registers: no atomics,
//     one fixed order, so two runs give the same bits.
//   * flash_bwd_dq: one block of 4 warps per (batch, head, 64 query
//     rows), 16 rows a warp; it loops over the visible key tiles and
//     accumulates dQ += dS K in registers.
// Every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// operands in padded shared memory, loaded synchronously, and P and dS
// going from accumulators straight into A fragments.
//
// Registers bound the plan at large D: a warp's 16 keys of dK and dV are
// D fp32 a thread. At D >= 128 the dK/dV block takes 32 keys, and the
// two warps of a key group split D between them (each recomputes the
// group's S^T and dP^T over the whole D); at D = 256 a query step is 32
// rows, and the dQ block steps over 32 keys.
//
// What bounds it on an H100: 5 products of S x T x D a head (2.5x the
// forward's flops) at the model's shapes, so the tensor cores; mma.sync
// from synchronously loaded shared memory reaches a fraction of their
// rate. wgmma and TMA (as on the forward's route) are a later step.
#include "mma_bf16.cuh"

namespace {

constexpr int WARPS = 4, PAD = 8;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Plan {
  static constexpr int BN = D >= 128 ? 32 : 64;   // keys of a dK/dV block
  static constexpr int KG = BN / 16;               // key groups of 16
  static constexpr int DSPLIT = WARPS / KG;        // warps sharing a group
  static constexpr int DW = D / DSPLIT;            // dK, dV columns a warp owns
  static constexpr int BM = D == 256 ? 32 : 64;    // query rows a dK/dV step
  static constexpr int QBM = 64;                   // query rows of a dQ block
  static constexpr int QBN = D == 256 ? 32 : 64;   // keys a dQ step
  static constexpr int LD = D + PAD;
  static constexpr int dkv_smem = (2 * BN + 2 * BM) * LD * 2 + 2 * BM * 4;
  static constexpr int dq_smem = (2 * QBM + 2 * QBN) * LD * 2;
};

__device__ __forceinline__ bool visible(int q, int k, int S, int T, int causal,
                                        int window) {
  return q < S && k < T && (!causal || k <= q) && (window <= 0 || q - k < window);
}

// rows [r0, r0 + rows) of a (rows, D) slab with row stride `rs` into
// shared memory [rows][LD], zeros past `n` valid rows
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int r0, int rows,
                                          int n) {
  constexpr int LD = D + PAD;
  for (int v = threadIdx.x; v < rows * D / 8; v += WARPS * 32) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    load8(dst + r * LD + c, src + (long long)(r0 + r) * rs + c,
          r0 + r < n ? 8 : 0, true);
  }
}

// acc[j] += A (16 rows of `a`, k along D) x B^T (8 rows of `b` a j, k
// along D): S = Q K^T's form, for N = 8 * NJ columns
template <int D, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4], const bf16* a,
                                         const bf16* b) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const bf16* pa = a + g * LD + kk + 2 * t;
    const uint32_t af[4] = {ld_pair(pa), ld_pair(pa + 8 * LD), ld_pair(pa + 8),
                            ld_pair(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* pb = b + (j * 8 + g) * LD + kk + 2 * t;
      const uint32_t bf[2] = {ld_pair(pb), ld_pair(pb + 8)};
      mma_bf16_16816(acc[j], af, bf);
    }
  }
}

// acc[i] += P (16 x 8*NJ fp32 in the C layout, rounded to bf16) x B (NJ*8
// rows of `b`, columns 8*NI from `b`'s start): O += P V's form
template <int D, int NJ, int NI>
__device__ __forceinline__ void mma_p(float (&acc)[NI][4],
                                      const float (&p)[NJ][4], const bf16* b) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    const uint32_t af[4] = {pack_f32(p[2 * kc][0], p[2 * kc][1]),
                            pack_f32(p[2 * kc][2], p[2 * kc][3]),
                            pack_f32(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_f32(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    const bf16* pb = b + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const uint32_t bf[2] = {pack_bf16(pb[i * 8], pb[LD + i * 8]),
                              pack_bf16(pb[8 * LD + i * 8], pb[9 * LD + i * 8])};
      mma_bf16_16816(acc[i], af, bf);
    }
  }
}

// Delta = rowsum(dO * O) in fp32 for every (batch, head, row), one warp a
// row; delta is (B, H, S) contiguous
__global__ void __launch_bounds__(256)
flash_bwd_delta(const bf16* __restrict__ O, const bf16* __restrict__ dO,
                float* __restrict__ delta, int H, int S, int D, long long osb,
                long long osh, long long oss, long long dsb, long long dsh,
                long long dss, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = (int)(r % S);
  const long long bh = r / S;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const bf16* o = O + b * osb + h * osh + s * oss;
  const bf16* d = dO + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32)
    acc += __bfloat162float(o[c]) * __bfloat162float(d[c]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// dK, dV for keys [n0, n0 + BN) of KV head hk: grid (key tiles, B * KV).
// Warp w owns keys n0 + 16 (w % KG) + (0..15) and columns DW (w / KG) ..
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv(const bf16* __restrict__ Q, const bf16* __restrict__ K,
              const bf16* __restrict__ V, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int KV,
              int S, int T, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, long long dsb, long long dsh,
              long long dss, int causal, int window, float scale) {
  using P = Plan<D>;
  constexpr int LD = P::LD, BN = P::BN, BM = P::BM, DW = P::DW;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BN][LD]
  bf16* Vs = Ks + BN * LD;                   // [BN][LD]
  bf16* Qs = Vs + BN * LD;                   // [BM][LD]
  bf16* dOs = Qs + BM * LD;                  // [BM][LD]
  float* Ls = reinterpret_cast<float*>(dOs + BM * LD);  // [BM] lse * log2(e)
  float* Ds = Ls + BM;                                  // [BM] Delta

  const int n0 = blockIdx.x * BN;
  const int b = blockIdx.y / KV, hk = blockIdx.y % KV, G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp % P::KG, c0 = (warp / P::KG) * DW;
  const int key0 = n0 + kg * 16 + g;  // this thread's keys: key0, key0 + 8
  const float sl2 = scale * LOG2E;

  load_tile<D>(Ks, K + b * ksb + hk * ksh, kss, n0, BN, T);
  load_tile<D>(Vs, V + b * vsb + hk * vsh, vss, n0, BN, T);

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int i = 0; i < DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  // the query tiles that see any key of the block: causal, q >= n0; a
  // window, q < n0 + BN - 1 + window
  const int m_begin = causal ? (n0 / BM) * BM : 0;
  const int m_end = window > 0 ? min(S, n0 + BN - 1 + window) : S;

  for (int hg = 0; hg < G; ++hg) {
    const int h = hk * G + hg;
    const bf16* Qg = Q + b * qsb + h * qsh;
    const bf16* dOg = dO + b * dsb + h * dsh;
    const long long row_base = (long long)(b * H + h) * S;
    for (int m0 = m_begin; m0 < m_end; m0 += BM) {
      __syncthreads();  // the last step's tiles are consumed
      load_tile<D>(Qs, Qg, qss, m0, BM, S);
      load_tile<D>(dOs, dOg, dss, m0, BM, S);
      for (int r = threadIdx.x; r < BM; r += WARPS * 32) {
        const bool in = m0 + r < S;
        Ls[r] = in ? lse[row_base + m0 + r] * LOG2E : 0.f;
        Ds[r] = in ? delta[row_base + m0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, then P^T = exp(s - lse) on the visible pairs
      float pt[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
      mma_rows<D, BM / 8>(pt, Ks + kg * 16 * LD, Qs);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          const int kpos = key0 + 8 * (e >> 1);
          pt[j][e] = visible(m0 + qc, kpos, S, T, causal, window)
                         ? exp2f(pt[j][e] * sl2 - Ls[qc])
                         : 0.f;
        }
      // dV += P^T dO
      mma_p<D, BM / 8, DW / 8>(dv, pt, dOs + c0);
      // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta)
      float dst[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) dst[j][0] = dst[j][1] = dst[j][2] = dst[j][3] = 0.f;
      mma_rows<D, BM / 8>(dst, Vs + kg * 16 * LD, dOs);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[j][e] = pt[j][e] * (dst[j][e] - Ds[j * 8 + 2 * t + (e & 1)]);
      // dK += dS^T Q
      mma_p<D, BM / 8, DW / 8>(dk, dst, Qs + c0);
    }
  }

  // out: dK = scale dS^T Q and dV, bf16, (B, KV, T, D) contiguous
  const long long base = ((long long)(b * KV + hk) * T) * D;
#pragma unroll
  for (int i = 0; i < DW / 8; ++i) {
    const int col = c0 + i * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key < T) {
        const long long at = base + (long long)key * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dK + at) = __floats2bfloat162_rn(
            dk[i][2 * r] * scale, dk[i][2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dV + at) =
            __floats2bfloat162_rn(dv[i][2 * r], dv[i][2 * r + 1]);
      }
    }
  }
}

// dQ for query rows [q0, q0 + QBM) of head h: grid (query tiles, B * H);
// warp w owns rows q0 + 16 w + (0..15)
template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq(const bf16* __restrict__ Q, const bf16* __restrict__ K,
             const bf16* __restrict__ V, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dQ, int H, int KV, int S, int T,
             long long qsb, long long qsh, long long qss, long long ksb,
             long long ksh, long long kss, long long vsb, long long vsh,
             long long vss, long long dsb, long long dsh, long long dss,
             int causal, int window, float scale) {
  using P = Plan<D>;
  constexpr int LD = P::LD, BQ = P::QBM, BN = P::QBN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                  // [BQ][LD]
  bf16* Ks = dOs + BQ * LD;                  // [BN][LD]
  bf16* Vs = Ks + BN * LD;                   // [BN][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = scale * LOG2E;
  const long long row_base = (long long)(b * H + h) * S;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l2[r] = row < S ? lse[row_base + row] * LOG2E : 0.f;
    dl[r] = row < S ? delta[row_base + row] : 0.f;
  }

  load_tile<D>(Qs, Q + b * qsb + h * qsh, qss, q0, BQ, S);
  load_tile<D>(dOs, dO + b * dsb + h * dsh, dss, q0, BQ, S);
  const bf16* Kg = K + b * ksb + hk * ksh;
  const bf16* Vg = V + b * vsb + hk * vsh;

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const int t_end = causal ? min(T, q0 + BQ) : T;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BN * BN : 0;
  for (int n0 = t_begin; n0 < t_end; n0 += BN) {
    __syncthreads();  // the last tiles are consumed (and Q, dO stored)
    load_tile<D>(Ks, Kg, kss, n0, BN, T);
    load_tile<D>(Vs, Vg, vss, n0, BN, T);
    __syncthreads();

    // S = Q K^T, P = exp(s - lse) on the visible pairs
    float p[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    mma_rows<D, BN / 8>(p, Qs + warp * 16 * LD, Ks);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p[j][e] = visible(row0 + 8 * r, n0 + j * 8 + 2 * t + (e & 1), S, T,
                          causal, window)
                      ? exp2f(p[j][e] * sl2 - l2[r])
                      : 0.f;
      }
    // dP = dO V^T, dS = P (dP - Delta)
    float ds[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
    mma_rows<D, BN / 8>(ds, dOs + warp * 16 * LD, Vs);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl[e >> 1]);
    // dQ += dS K
    mma_p<D, BN / 8, D / 8>(dq, ds, Ks);
  }

  // out: dQ = scale dS K, bf16, (B, H, S, D) contiguous
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(dQ + (row_base + row) * D + col) =
            __floats2bfloat162_rn(dq[i][2 * r] * scale, dq[i][2 * r + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* d_o, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int H,
                   int KV, int S, int T, const long long* qs,
                   const long long* ks, const long long* vs,
                   const long long* os, const long long* ds, int causal,
                   int window, float scale, cudaStream_t stream) {
  using P = Plan<D>;
  // once per instantiation, outside any CUDA-graph capture of later calls
  static cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::dkv_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::dq_smem);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const auto* Q = static_cast<const bf16*>(q);
  const auto* K = static_cast<const bf16*>(k);
  const auto* V = static_cast<const bf16*>(v);
  const auto* dO = static_cast<const bf16*>(d_o);
  const long long rows = (long long)B * H * S;
  flash_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(o), dO, delta, H, S, D, os[0], os[1], os[2],
      ds[0], ds[1], ds[2], rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<D><<<dim3((T + P::BN - 1) / P::BN, B * KV), WARPS * 32,
                     P::dkv_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, KV, S, T, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], ds[0], ds[1], ds[2], causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq<D><<<dim3((S + P::QBM - 1) / P::QBM, B * H), WARPS * 32,
                    P::dq_smem, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dq), H, KV, S, T, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1],
      ds[2], causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, do: (B,H,S,D); k, v: (B,KV,T,D), each given by element strides
// (batch, head, row) with unit stride along D; lse: (B,H,S) fp32, the
// forward's row log-sum-exp; delta: (B,H,S) fp32 scratch; dq (B,H,S,D)
// and dk, dv (B,KV,T,D) contiguous outputs. Returns the cudaError_t of
// the launches (0 on success). The caller has checked H % KV == 0, D in
// {16, 32, 64, 128, 256}, 16-byte alignment of pointers and strides, and
// S, T > 0.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int H, int KV, int S, int T, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, int causal,
    int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss},
                  vs[3] = {vsb, vsh, vss}, os[3] = {osb, osh, oss},
                  ds[3] = {dsb, dsh, dss};
  const float* L = static_cast<const float*>(lse);
  float* Dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define REPRO_FA_BWD(d)                                                      \
  case d:                                                                    \
    return launch<d>(q, k, v, o, d_o, L, Dl, dq, dk, dv, B, H, KV, S, T, qs, \
                     ks, vs, os, ds, causal, window, scale, s);
    REPRO_FA_BWD(16)
    REPRO_FA_BWD(32)
    REPRO_FA_BWD(64)
    REPRO_FA_BWD(128)
    REPRO_FA_BWD(256)
#undef REPRO_FA_BWD
    default:
      return cudaErrorInvalidValue;
  }
}
