// Flash-attention forward, bf16 in and out, fp32 softmax state.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:23,71): an online softmax over KV
// blocks with a running max, a denominator and an fp32 accumulator, P cast
// to V's dtype before P.V, causal masking by index with the top-left rule
// (kpos <= qpos), out-of-range V rows zeroed, output acc / max(l, 1e-30).
// Beyond the Pallas kernel it takes native GQA (q (B,H,S,D), k/v
// (B,KV,T,D), head h reads KV head h / (H/KV)), a sliding window
// (qpos - kpos < window, 0 = none) and a score scale (the model passes 1.0
// because its q is scaled already).
//
// What bounds it on an H100: at the model's prefill shapes (S = T = 1024,
// D = 256) each KV tile loaded is used by 64 query rows, so the kernel is
// bound by the tensor cores (989 TFLOP/s bf16) and by the softmax's
// exponentials, not by HBM. D = 256 is what presses: a 64x256 fp32
// accumulator is 64 KB, and Q, K and V tiles of 64x256 bf16 are 32 KB each.
//
// What the design does about it:
//   * one block of 4 warps per (batch, head, 64-row q tile); each warp owns
//     16 query rows, so its slice of the accumulator (16 x D fp32) lives in
//     registers in the mma.sync C layout, where every thread knows its rows
//     and can rescale by the running max without a trip through memory;
//   * S = Q K^T and O += P V run on the tensor cores (m16n8k16, fp32
//     accumulate); P goes from the S accumulators straight into A fragments
//     (the C layout of two n8 tiles is the A layout of one k16 step);
//   * Q, K and V tiles sit in dynamic shared memory (3 x 64 x (D+8) bf16:
//     101 KB at D = 256, opted in with cudaFuncSetAttribute);
//   * KV tiles that the causal rule or the window masks wholly are skipped,
//     which changes no result: the Pallas kernel runs them for zeros.
// Not yet: TMA, wgmma, double-buffered K/V tiles, exp2 with folded scale.
#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, PAD = 8, WARPS = 4;
constexpr float NEG_INF = -2.0e38f;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_bf16(const bf16* __restrict__ Q, const bf16* __restrict__ K,
               const bf16* __restrict__ V, bf16* __restrict__ O, int H,
               int KV, int S, int T, long long qsb, long long qsh,
               long long qss, long long ksb, long long ksh, long long kss,
               long long vsb, long long vsh, long long vss, int causal,
               int window, float scale) {
  constexpr int LD = D + PAD;
  constexpr int NT = WARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                   // [BKV][LD]
  bf16* Vs = Ks + BKV * LD;                  // [BKV][LD]

  // heaviest causal tiles (last rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KV);
  const bf16* Qg = Q + b * qsb + h * qsh;
  const bf16* Kg = K + b * ksb + hk * ksh;
  const bf16* Vg = V + b * vsb + hk * vsh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int row1 = row0 + 8;

  for (int v = tid; v < BQ * D / 8; v += NT) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    load8(Qs + r * LD + c, Qg + (q0 + r) * qss + c, q0 + r < S ? 8 : 0, true);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  const int t_end = causal ? min(T, q0 + BQ) : T;
  int t_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  t_begin = (t_begin / BKV) * BKV;

  for (int kv0 = t_begin; kv0 < t_end; kv0 += BKV) {
    __syncthreads();  // the previous tile is consumed (and Q is stored)
    for (int v = tid; v < BKV * D / 8; v += NT) {
      const int r = v / (D / 8), c = (v % (D / 8)) * 8;
      const int n = kv0 + r < T ? 8 : 0;
      load8(Ks + r * LD + c, Kg + (kv0 + r) * kss + c, n, true);
      load8(Vs + r * LD + c, Vg + (kv0 + r) * vss + c, n, true);
    }
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const bf16* qa = Qs + (warp * 16 + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD),
                             ld_pair(qa + 8), ld_pair(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const bf16* kb = Ks + (j * 8 + g) * LD + kk + 2 * t;
        const uint32_t bb[2] = {ld_pair(kb), ld_pair(kb + 8)};
        mma_bf16_16816(s[j], a, bb);
      }
    }

    // scale, mask, and the running max of each of the thread's two rows
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? row0 : row1;
        const int kpos = kv0 + j * 8 + 2 * t + (e & 1);
        const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    float alpha[2], tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores hold NEG_INF; like the Pallas kernel, their p is 0
        const float p = s[j][e] == NEG_INF ? 0.f : expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        tsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
      l[r] = l[r] * alpha[r] + tsum[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 (V's dtype) as at flash_attention.py:58
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                             pack_f32(s[2 * kc][2], s[2 * kc][3]),
                             pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const bf16* vb = Vs + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const uint32_t bb[2] = {
            pack_bf16(vb[i * 8], vb[LD + i * 8]),
            pack_bf16(vb[8 * LD + i * 8], vb[9 * LD + i * 8])};
        mma_bf16_16816(o[i], a, bb);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  bf16* Og = O + ((long long)(b * H + h) * S) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(Og + (long long)row0 * D + col) =
          __floats2bfloat162_rn(o[i][0] * inv0, o[i][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(Og + (long long)row1 * D + col) =
          __floats2bfloat162_rn(o[i][2] * inv1, o[i][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int T, const long long* qs,
                   const long long* ks, const long long* vs, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int smem = 3 * BQ * (D + PAD) * (int)sizeof(bf16);
  // once per instantiation, so that no attribute call falls inside a
  // CUDA-graph capture of a later launch
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_bf16<D><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, KV, S, T, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B,H,S,D), k/v: (B,KV,T,D) given by element strides (batch, head,
// row) with unit stride along D; o: (B,H,S,D) contiguous. Returns the
// cudaError_t of the launch (0 on success). The caller has checked D in
// {16, 32, 64, 128, 256}, H % KV == 0, 16-byte alignment of pointers and strides,
// and S, T > 0.
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int T, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int causal, int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss},
                  vs[3] = {vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                        window, scale, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                        window, scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                        window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                         window, scale, s);
    case 256:
      return launch<256>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                         window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
