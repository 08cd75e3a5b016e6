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
// D = 256) each KV tile loaded is used by 64 or 128 query rows, so the
// kernel is bound by the tensor cores (989 TFLOP/s bf16) and by the
// softmax's exponentials, not by HBM. D = 256 is what presses: a 64x256
// fp32 accumulator is 128 registers a thread, and Q, K and V tiles of
// 64x256 bf16 are 32 KB each.
//
// Two routes, chosen by the wrapper (kernels/flash_attention.py `route`)
// from D before the launch:
//   * wgmma (D in {64, 128, 256}, every prefill call of gemma3-1b): one
//     block of three warpgroups per (batch, head, 128-row q tile). A
//     producer warpgroup, its registers handed to the others with
//     setmaxnreg, has one thread load Q once and K and V tiles of 64 keys
//     into a ring (2 stages at D = 256: 64 KB of Q and 2 x 64 KB of K and
//     V, 193 KB; 4 at D <= 128) by TMA, over 4-D tensor maps made from the
//     operands' own strides, so the model's transposed views are read in
//     place and rows past S or T arrive as zeros (the Pallas kernel's
//     zeroed V rows). K and V have their own "full" and "empty" mbarriers,
//     so the next K tile loads as soon as S = Q.K^T has read the last one.
//     Two consumer warpgroups own 64 query rows each: S by wgmma m64n64k16
//     from 128-byte-swizzled shared memory (Q and K both D-contiguous),
//     the softmax on the accumulator in registers with exp2 (ex2.approx)
//     and log2(e)*scale folded into one FMA, then O += P.V by wgmma m64nDk16
//     with P as the A operand from registers (the S accumulator packed
//     pairwise to bf16, as in FlashAttention-3) and V read N-major. A
//     tile's P.V stays in flight while the next tile's Q.K^T is issued.
//     The softmax has one instance for the tiles a mask cuts and one that
//     tests nothing per score (on the card a test per score, compiled to
//     a branch each, slowed the whole kernel). A warpgroup's wholly
//     masked tiles form a prefix and a suffix of its block's tiles, which
//     it passes over outside its main loop: a branch around a wgmma
//     inside the loop makes ptxas serialise the wgmma pipeline. The
//     output goes through shared memory (Q's slot) and leaves by TMA
//     stores.
//   * mma_sync (D in {16, 32}, rows narrower than the 128-byte swizzle
//     atom): one block of 4 warps per (batch, head, 64-row q tile); each
//     warp owns 16 query rows, its slice of the accumulator (16 x D fp32)
//     in registers in the mma.sync C layout; S = Q K^T and O += P V on
//     mma.sync m16n8k16 with P going from the S accumulators straight into
//     A fragments; Q, K and V tiles in dynamic shared memory (3 x 64 x
//     (D+8) bf16), loaded synchronously.
// Both write, when given a pointer, the fp32 row log-sum-exp of the scaled
// scores (m + log l) in the epilogue, for the backward pass
// (csrc/flash_attention_bwd.cu); serving passes null.
// Both skip KV tiles that the causal rule or the window masks wholly,
// which changes no result (the Pallas kernel runs them for zeros), and
// start with the heaviest causal q tiles.
// Not yet on the wgmma route: ping-pong of the two consumer warpgroups,
// overlap of the softmax with the wgmma inside a warpgroup, FP8.
#include "mma_bf16.cuh"
#include "sm90.cuh"

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
               int window, float scale, float* __restrict__ L) {
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
  if (L != nullptr && t == 0) {  // the row log-sum-exp m + log l (-inf: no key)
    float* Lg = L + (long long)(b * H + h) * S;
    if (row0 < S) Lg[row0] = m[0] + logf(l[0]);
    if (row1 < S) Lg[row1] = m[1] + logf(l[1]);
  }
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
                   int window, float scale, float* lse, cudaStream_t stream) {
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
      scale, lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma

namespace wg {
constexpr int BQ = 128, BKV = 64;    // a block's query rows; keys a ring stage
constexpr int THREADS = 384;         // a producer and two consumer warpgroups
// a box: rows of 64 bf16 (128 bytes, one band of the swizzle), 64 of Q or
// O (8 KB), BKV of K or V
constexpr int QBOX = 64 * 128, KVBOX = BKV * 128;
__host__ __device__ constexpr int stages(int d) { return d == 256 ? 2 : 4; }
__host__ __device__ constexpr int q_bytes(int d) { return BQ * d * 2; }
__host__ __device__ constexpr int kv_bytes(int d) { return BKV * d * 2; }
// Q, then the K ring, then the V ring, + room to align to 1024 bytes
// (kernels/flash_attention.py `wgmma_smem_bytes` mirrors this)
__host__ __device__ constexpr int smem_bytes(int d) {
  return q_bytes(d) + 2 * stages(d) * kv_bytes(d) + 1024;
}
}  // namespace wg

// The softmax of one tile of S for a consumer thread's two rows (row0 and
// row0 + 8) in the accumulator layout of wgmma m64nNk16, and the rescale
// of its O. Scores are oriented (NEG: negated) so that the largest is the
// one with the largest scaled value; the running max m is kept in those
// units and `sl2` = |scale| * log2(e) maps them to log2 units. On an EDGE
// tile (one the mask cuts) masked scores get NEG_INF for the max and p = 0;
// the other tiles run without a test per score. l gathers this thread's
// share of each row sum (reduced over the quad at the end); P leaves as
// bf16 pairs in `pa`, the A operand of P.V.
template <bool NEG, bool EDGE, int D, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N / 2], float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pa)[N / 4], int row0,
                                             int kv0, int T, int causal,
                                             int window, float sl2) {
  const int c2 = 2 * (threadIdx.x % 4);
  float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float x = NEG ? -sc[i] : sc[i];
    if constexpr (EDGE) {
      const int qpos = row0 + 8 * ((i >> 1) & 1);
      const int kpos = kv0 + 8 * (i >> 2) + c2 + (i & 1);
      const bool ok = kpos < T && (!causal || kpos <= qpos) &&
                      (window <= 0 || qpos - kpos < window);
      x = ok ? x : NEG_INF;
    }
    sc[i] = x;
    tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], x);
  }
  float alpha[2], ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    ms[r] = m_new * sl2;
    // 1 while the row has seen no key (both NEG_INF): the difference, not
    // an FMA, whose rounding residual at NEG_INF could overflow exp2
    alpha[r] = sm90::exp2_approx((m[r] - m_new) * sl2);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = sm90::exp2_approx(fmaf(sc[i], sl2, -ms[r]));
    if constexpr (EDGE) p = sc[i] == NEG_INF ? 0.f : p;  // as in the Pallas kernel
    sc[i] = p;
    l[r] += p;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {  // P rounded to bf16 (V's dtype), as at flash_attention.py:58
    const __nv_bfloat162 pr = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
    pa[j] = *reinterpret_cast<const uint32_t*>(&pr);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// One (batch, head, 128-row q tile) per block: grid (q tiles, B * H), the
// heaviest causal tiles first. Warpgroup 0 produces; warpgroups 1 and 2
// consume rows q0 .. q0+63 and q0+64 .. q0+127. `sl2` is scale * log2(e).
// Shared memory holds 64-row boxes of 64 columns (128 bytes a row, the
// 128-byte swizzle TMA writes and wgmma reads): Q as [consumer][D/64],
// each ring stage of K and of V as [D/64].
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, int H, int KV, int S,
                int T, int causal, int window, float sl2,
                float* __restrict__ L) {
  constexpr int BQ = wg::BQ, BKV = wg::BKV, QBOX = wg::QBOX, KVBOX = wg::KVBOX;
  static_assert(BKV == 64, "S = Q K^T is one wgmma m64n64k16 a k-step");
  constexpr int STAGES = wg::stages(D), NB = D / 64, KVB = wg::kv_bytes(D);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = Qs + wg::q_bytes(D);
  uint8_t* Vs = Ks + STAGES * KVB;
  __shared__ __align__(8) uint64_t q_full, k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / KV);
  // the block's KV tiles: those any of its rows may see
  const int t_end = causal ? min(T, q0 + BQ) : T;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + BKV - 1) / BKV : 0;

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 2);  // one arrival per consumer warpgroup
      sm90::mbar_init(&v_empty[s], 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, wg::q_bytes(D));
      for (int j = 0; j < 2 * NB; ++j)
        sm90::tma_load_4d(Qs + j * QBOX, &tq, &q_full, 64 * (j % NB),
                          q0 + 64 * (j / NB), h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kv0 = t_begin + i * BKV;
        const uint32_t ph = (i / STAGES - 1) & 1;
        if (i >= STAGES) sm90::mbar_wait(&k_empty[s], ph);
        sm90::mbar_arrive_expect_tx(&k_full[s], KVB);
        for (int j = 0; j < NB; ++j)
          sm90::tma_load_4d(Ks + s * KVB + j * KVBOX, &tk, &k_full[s], 64 * j,
                            kv0, hk, b);
        if (i >= STAGES) sm90::mbar_wait(&v_empty[s], ph);
        sm90::mbar_arrive_expect_tx(&v_full[s], KVB);
        for (int j = 0; j < NB; ++j)
          sm90::tma_load_4d(Vs + s * KVB + j * KVBOX, &tv, &v_full[s], 64 * j,
                            kv0, hk, b);
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int w = tid / 128 - 1, t = tid % 128, lane = t % 32;
  const int r_lo = q0 + 64 * w;                       // the warpgroup's rows
  const int row0 = r_lo + 16 * (t / 32) + lane / 4;   // this thread's: row0, row0 + 8
  const uint32_t q_base = sm90::smem_u32(Qs + w * NB * QBOX);
  const bool neg = sl2 < 0.f;
  const float asl2 = fabsf(sl2);

  float o[D / 2], sc[BKV / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t pa[BKV / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  // The tiles this warpgroup computes, [i_lo, i_hi): the window hides a
  // prefix of the block's tiles from its rows, the causal rule a suffix.
  // It only waits for the others and hands their slots back, so that no
  // branch inside the loop below decides whether a wgmma runs (a branch
  // there makes ptxas serialise the wgmma pipeline).
  auto hidden = [&](int i) {
    const int kv0 = t_begin + i * BKV;
    return r_lo >= S || (causal && kv0 > r_lo + 63) ||
           (window > 0 && r_lo - (kv0 + BKV - 1) >= window);
  };
  int i_lo = 0, i_hi = n_tiles;
  while (i_lo < i_hi && hidden(i_lo)) ++i_lo;
  while (i_hi > i_lo && hidden(i_hi - 1)) --i_hi;
  auto pass = [&](int i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    sm90::mbar_wait(&k_full[s], ph);
    sm90::mbar_wait(&v_full[s], ph);
    if (t == 0) {
      sm90::mbar_arrive(&k_empty[s]);
      sm90::mbar_arrive(&v_empty[s]);
    }
  };

  sm90::mbar_wait(&q_full, 0);
  for (int i = 0; i < i_lo; ++i) pass(i);
  for (int i = i_lo; i < i_hi; ++i) {
    const int s = i % STAGES, kv0 = t_begin + i * BKV;
    const uint32_t ph = (i / STAGES) & 1;
    // S = Q K^T: A = Q (K-major), B = K (K-major)
    const uint32_t k_base = sm90::smem_u32(Ks + s * KVB);
    sm90::mbar_wait(&k_full[s], ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t along = (kk % 4) * 32;  // 32 bytes a k16 step
      sm90::wgmma_m64n64k16<0>(
          sc, sm90::desc_sw128(q_base + (kk / 4) * QBOX + along, 16, 1024),
          sm90::desc_sw128(k_base + (kk / 4) * KVBOX + along, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // this tile's Q.K^T and the last tile's P.V
    sm90::fence_regs(sc);
    sm90::fence_regs(o);
    if (t == 0) {
      sm90::mbar_arrive(&k_empty[s]);
      if (i > i_lo) sm90::mbar_arrive(&v_empty[(i - 1) % STAGES]);
    }
    const bool edge = kv0 + BKV > T || (causal && kv0 + BKV - 1 > r_lo) ||
                      (window > 0 && r_lo + 63 - kv0 >= window);
    if (edge && neg)
      softmax_tile<true, true, D, BKV>(sc, o, m, l, pa, row0, kv0, T, causal,
                                  window, asl2);
    else if (edge)
      softmax_tile<false, true, D, BKV>(sc, o, m, l, pa, row0, kv0, T, causal,
                                   window, asl2);
    else if (neg)
      softmax_tile<true, false, D, BKV>(sc, o, m, l, pa, row0, kv0, T, causal,
                                   window, asl2);
    else
      softmax_tile<false, false, D, BKV>(sc, o, m, l, pa, row0, kv0, T, causal,
                                    window, asl2);
    // O += P V: A = P from registers, B = V (N-major), 16 keys a step
    const uint32_t v_base = sm90::smem_u32(Vs + s * KVB);
    sm90::mbar_wait(&v_full[s], ph);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2],
                             pa[4 * kc + 3]};
      sm90::wgmma_m64k16_rs<D, 1>(
          o, a, sm90::desc_sw128(v_base + kc * 16 * 128, KVBOX, 1024));
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  if (t == 0 && i_hi > i_lo) sm90::mbar_arrive(&v_empty[(i_hi - 1) % STAGES]);
  for (int i = i_hi; i < n_tiles; ++i) pass(i);

  // Epilogue: O / max(l, 1e-30) as bf16 into this warpgroup's Q boxes, in
  // their swizzle (a row's 16-byte chunk c sits at c ^ (row % 8)), then out
  // by TMA; rows past S are not written.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // the row log-sum-exp in scaled units: the scaled score is |scale| x the
  // oriented one, so lse = |scale| m + ln l = (m asl2 + log2 l) ln 2
  if (L != nullptr && lane % 4 == 0) {
    float* Lg = L + (long long)(b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < S)
        Lg[row0 + 8 * r] = (m[r] * asl2 + log2f(l[r])) * 0.6931471805599453f;
  }
  sm90::bar_sync(1 + w, 128);  // every warp's wgmma has done reading Q
  uint8_t* out = Qs + w * NB * QBOX;
  const int rr = row0 - r_lo, g = lane / 4;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const __nv_bfloat162 v2 =
        __floats2bfloat162_rn(o[i] * inv[r], o[i + 1] * inv[r]);
    *reinterpret_cast<__nv_bfloat162*>(
        out + (i / 32) * QBOX + (rr + 8 * r) * 128 + (((i / 4) % 8) ^ g) * 16 +
        (lane % 4) * 4) = v2;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1 + w, 128);
  if (t == 0 && r_lo < S) {
    for (int j = 0; j < NB; ++j)
      sm90::tma_store_4d(&to, out + j * QBOX, 64 * j, r_lo, h, b);
    sm90::tma_store_commit();
    sm90::tma_store_wait<0>();
  }
}

// Returns a cudaError_t, or -(CUresult) when a tensor map cannot be made.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int KV, int S, int T, const long long* qs,
                 const long long* ks, const long long* vs, int causal,
                 int window, float scale, float* lse, cudaStream_t stream) {
  if (!sm90::encode_fn()) return cudaErrorNotSupported;
  const long long os[3] = {(long long)H * S * D, (long long)S * D, D};
  CUtensorMap tq, tk, tv, to;
  CUresult r = sm90::encode_4d(&tq, q, D, S, H, B, qs, 64);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_4d(&tk, k, D, T, KV, B, ks, wg::BKV);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_4d(&tv, v, D, T, KV, B, vs, wg::BKV);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&to, o, D, S, H, B, os, 64);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  // once per instantiation, outside any CUDA-graph capture of later calls
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      wg::smem_bytes(D));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + wg::BQ - 1) / wg::BQ, B * H);
  flash_fwd_wgmma<D><<<grid, wg::THREADS, wg::smem_bytes(D), stream>>>(
      tq, tk, tv, to, H, KV, S, T, causal, window, scale * 1.4426950408889634f,
      lse);
  return cudaGetLastError();
}

}  // namespace

// q: (B,H,S,D), k/v: (B,KV,T,D) given by element strides (batch, head,
// row) with unit stride along D; o: (B,H,S,D) contiguous; lse: (B,H,S)
// fp32 contiguous, the row log-sum-exp of the scaled scores for the
// backward pass, or null to skip it (serving). `route` is the
// caller's choice (kernels/flash_attention.py ROUTES): 0 mma_sync for D in
// {16, 32}, 1 wgmma for D in {64, 128, 256}. Returns the cudaError_t of
// the launch (0 on success), or -(CUresult) when a TMA tensor map cannot
// be made. The caller has checked H % KV == 0, 16-byte alignment of
// pointers and strides, and S, T > 0.
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int T, int D, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, int causal, int window, float scale, int route, void* lse,
    void* stream) {
  float* L = static_cast<float*>(lse);
  const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss},
                  vs[3] = {vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route * 1000 + D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                        window, scale, L, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                        window, scale, L, s);
    case 1064:
      return launch_wgmma<64>(q, k, v, o, B, H, KV, S, T, qs, ks, vs, causal,
                              window, scale, L, s);
    case 1128:
      return launch_wgmma<128>(q, k, v, o, B, H, KV, S, T, qs, ks, vs,
                               causal, window, scale, L, s);
    case 1256:
      return launch_wgmma<256>(q, k, v, o, B, H, KV, S, T, qs, ks, vs,
                               causal, window, scale, L, s);
    default:
      return cudaErrorInvalidValue;
  }
}
