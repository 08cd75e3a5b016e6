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
// What bounds it on an H100: 5 products of S x T x D a head (2.5x the
// forward's flops) at the model's shapes, so the tensor cores.
//
// Every block owns the rows of the gradient it writes, and sums them in
// the one fixed order of its loops: no two blocks add into one element,
// so two runs give the same bits. On the caller's stream, on one of two
// routes the wrapper picks from D before the launch
// (kernels/flash_attention.py `bwd_route`):
//   * flash_bwd_delta (both routes): Delta, D / 8 threads a row; on the
//     wgmma route also lse * log2(e), both into rows padded to 64 a head.
//   * wgmma (D in {64, 128, 256}), FlashAttention-3's form with its dQ
//     made deterministic: one launch, flash_bwd_wgmma, whose blocks take
//     the dK/dV role or the dQ role, so that dQ blocks fill the SMs that
//     the causal rule leaves idle under the dK/dV blocks. Tiles are
//     128-byte swizzled and loaded by TMA over 4-D tensor maps of the
//     operands' own strides (rows past S or T arrive as zeros); every
//     product is a wgmma.
//       - dK/dV (dkv_block): a block per (key tile, batch, KV head), a
//         producer warpgroup and two consumer warpgroups. The producer
//         loads the block's K and V once, then streams 64-row Q and dO
//         tiles with their lse and Delta rows (bulk copies) through a
//         ring of "full" and "empty" mbarriers, for each q head of the KV
//         head in turn and each query tile that sees the keys (tiles the
//         causal rule or the window masks wholly are not loaded). A
//         consumer, per tile: S^T = K Q^T (wgmma m64n64k16, both
//         operands D-contiguous); P^T = exp2(S^T scale log2e - lse
//         log2e) in registers, the mask applied only in the instance for
//         cut tiles; dV += P^T dO with P^T packed to bf16 as the A
//         operand from registers and dO read N-major; dP^T = V dO^T;
//         dS^T = P^T (dP^T - Delta); dK += dS^T Q, dS^T from registers.
//         At D <= 128 each consumer owns 64 keys of a 128-key tile, its
//         dK and dV (64 x D fp32 each) in registers; at D = 256 those
//         would be 256 registers a thread, so both consumers take the
//         same 64 keys and split dK's and dV's columns, each computing
//         S^T and dP^T over the whole D (9 products of the 5).
//       - dQ (dq_block): a block per (128 query rows, batch, head), the
//         forward's layout: the producer loads Q and dO once and streams
//         K and V tiles (64 keys, 32 at D = 256) through a ring; each
//         consumer owns 64 rows, computes S = Q K^T and dP = dO V^T, P
//         and dS in registers, and dQ += dS K with dS from registers. It
//         recomputes S and dP, the price of owning its rows: 7 products
//         where the work needs 5.
//     A consumer's wholly masked tiles form a prefix and a suffix of
//     its tiles, passed over outside its main loop: a branch around a
//     wgmma inside the loop makes ptxas serialise the wgmma pipeline.
//     Results leave through shared memory by TMA stores.
//   * mma_sync (D in {16, 32}, rows narrower than the 128-byte swizzle
//     atom): FlashAttention-2's form on mma.sync m16n8k16 from padded
//     shared memory, loaded synchronously. flash_bwd_dkv: one block of 4
//     warps per (batch, KV head, 64 keys), 16 keys a warp, looping over
//     the q heads and the query tiles that see its keys; flash_bwd_dq:
//     one block of 4 warps per (batch, head, 64 query rows), 16 rows a
//     warp, looping over the visible key tiles.
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int q, int k, int S, int T, int causal,
                                        int window) {
  return q < S && k < T && (!causal || k <= q) && (window <= 0 || q - k < window);
}

// Delta = rowsum(dO * O) in fp32 for every (batch, head, row) into (B, H,
// Sp) rows (zeros at rows S .. Sp - 1), D / 8 threads a row with 16-byte
// loads; with `lse2`, also lse * log2(e) there (0 past S)
__global__ void __launch_bounds__(256)
flash_bwd_delta(const bf16* __restrict__ O, const bf16* __restrict__ dO,
                const float* __restrict__ lse, float* __restrict__ delta,
                float* __restrict__ lse2, int H, int S, int Sp, int D,
                long long osb, long long osh, long long oss, long long dsb,
                long long dsh, long long dss, long long rows) {
  const int lanes = D / 8;  // a row's threads, a power of two within a warp
  const long long r = ((long long)blockIdx.x * 256 + threadIdx.x) / lanes;
  const int c = (threadIdx.x % lanes) * 8;
  const int s = (int)(r % Sp);
  const long long bh = r / Sp;
  const bool live = r < rows && s < S;
  float acc = 0.f;
  if (live) {
    const int h = (int)(bh % H), b = (int)(bh / H);
    const uint4 ov = *reinterpret_cast<const uint4*>(O + b * osb + h * osh +
                                                     s * oss + c);
    const uint4 dv = *reinterpret_cast<const uint4*>(dO + b * dsb + h * dsh +
                                                     s * dss + c);
    const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
      acc += of.x * df.x + of.y * df.y;
    }
  }
  for (int off = lanes / 2; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && c == 0) {
    delta[r] = acc;
    if (lse2 != nullptr) lse2[r] = live ? lse[bh * S + s] * LOG2E : 0.f;
  }
}

// ---------------------------------------------------------------- wgmma

namespace wg {
constexpr int THREADS = 384;  // a producer and two consumer warpgroups
constexpr int BOX = 64 * 128;  // a box of 64 rows of 64 bf16 (8 KB)
constexpr int BM = 64;         // query rows of a dK/dV ring stage
constexpr int BQ = 128;        // query rows of a dQ block
// dK/dV: at D = 256 the consumers share 64 keys and split the columns
__host__ __device__ constexpr bool split(int d) { return d == 256; }
__host__ __device__ constexpr int kv_keys(int d) { return split(d) ? 64 : 128; }
__host__ __device__ constexpr int kv_stages(int d) { return d == 256 ? 2 : 4; }
// dK/dV: K and V, the ring of Q and dO tiles, the ring of lse and Delta
// rows, and room to align to 1024 bytes (kernels/flash_attention.py
// `bwd_wgmma_smem_bytes` mirrors this and the next; a block has the
// larger of the two)
__host__ __device__ constexpr int kv_smem(int d) {
  return 2 * kv_keys(d) * d * 2 + kv_stages(d) * (2 * BM * d * 2 + 2 * BM * 4) +
         1024;
}
// dQ: keys of a ring stage; Q and dO, the ring of K and V tiles, alignment
__host__ __device__ constexpr int q_keys(int d) { return d == 256 ? 32 : 64; }
__host__ __device__ constexpr int q_stages(int d) { return d == 256 ? 2 : 4; }
__host__ __device__ constexpr int q_smem(int d) {
  return 2 * BQ * d * 2 + q_stages(d) * 2 * q_keys(d) * d * 2 + 1024;
}
}  // namespace wg

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~uintptr_t(1023));
}

// K-major operand of a D-wide tile made of 64-column boxes of `box`
// bytes: the descriptor of the k16 step kk
__device__ __forceinline__ uint64_t k_desc(uint32_t base, int kk, int box) {
  return sm90::desc_sw128(base + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// a 64-row fp32 accumulator (N/2 a thread) packed pairwise to bf16: the A
// operand of the next wgmma (sm90.cuh `wgmma_m64n64k16_rs`)
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) a[j] = pack_f32(x[2 * j], x[2 * j + 1]);
}

// The dK/dV consumer's tile in the S^T layout (rows keys key0 + 8 ((i >> 1)
// & 1), columns queries m0 + 8 (i >> 2) + 2 (t % 4) + (i & 1)): P^T from
// S^T in `st`, the mask tested only on an EDGE tile; Lt holds the tile's
// lse * log2(e)
template <bool EDGE>
__device__ __forceinline__ void p_tile_t(float (&st)[32], const float* Lt,
                                         int key0, int m0, int S, int T,
                                         int causal, int window, float sl2) {
  const int c2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(Lt + 8 * j + c2);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = sm90::exp2_approx(fmaf(st[4 * j + e], sl2, -(e & 1 ? l.y : l.x)));
      if constexpr (EDGE)
        p = visible(m0 + 8 * j + c2 + (e & 1), key0 + 8 * (e >> 1), S, T,
                    causal, window)
                ? p
                : 0.f;
      st[4 * j + e] = p;
    }
  }
}

// dK, dV for keys [n0, n0 + NK) of KV head hk of batch b: a block of
// flash_bwd_wgmma in its dK/dV role. Shared memory: K and V as [row block][D/64] boxes, the ring of Q and dO
// tiles as [D/64] boxes, the ring of lse * log2(e) and Delta rows.
template <int D>
__device__ __forceinline__ void dkv_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const CUtensorMap& tdk, const CUtensorMap& tdv,
    const float* __restrict__ lse2, const float* __restrict__ delta, int H,
    int KV, int S, int Sp, int T, int causal, int window, float sl2,
    float scale, int n0, int b, int hk, uint8_t* smem_raw) {
  constexpr int NB = D / 64, BOX = wg::BOX, BM = wg::BM;
  constexpr bool SPLIT = wg::split(D);
  constexpr int NK = wg::kv_keys(D), STAGES = wg::kv_stages(D);
  constexpr int DC = SPLIT ? D / 2 : D;  // dK, dV columns a consumer owns
  constexpr int TILE = BM * D * 2;       // bytes of a Q or dO tile
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + NK * D * 2;
  uint8_t* Qs = Vs + NK * D * 2;
  uint8_t* dOs = Qs + STAGES * TILE;
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * TILE);  // [STAGES][BM]
  float* Ds = Ls + STAGES * BM;                               // [STAGES][BM]
  __shared__ __align__(8) uint64_t kv_full, full[STAGES], empty[STAGES];

  const int tid = threadIdx.x, G = H / KV;
  // the query tiles that see any key of the block: causal, q >= n0; a
  // window, q < n0 + NK - 1 + window
  const int m_begin = causal ? n0 / BM * BM : 0;
  const int m_end = window > 0 ? min(S, n0 + NK - 1 + window) : S;
  const int nm = m_end > m_begin ? (m_end - m_begin + BM - 1) / BM : 0;

  if (tid == 0) {
    sm90::mbar_init(&kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(&kv_full, 2 * NK * D * 2);
      for (int j = 0; j < NK / 64 * NB; ++j) {
        sm90::tma_load_4d(Ks + j * BOX, &tk, &kv_full, 64 * (j % NB),
                          n0 + 64 * (j / NB), hk, b);
        sm90::tma_load_4d(Vs + j * BOX, &tv, &kv_full, 64 * (j % NB),
                          n0 + 64 * (j / NB), hk, b);
      }
      for (int i = 0; i < G * nm; ++i) {
        const int s = i % STAGES, h = hk * G + i / nm;
        const int m0 = m_begin + (i % nm) * BM;
        if (i >= STAGES) sm90::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * TILE + 2 * BM * 4);
        for (int j = 0; j < NB; ++j) {
          sm90::tma_load_4d(Qs + s * TILE + j * BOX, &tq, &full[s], 64 * j, m0,
                            h, b);
          sm90::tma_load_4d(dOs + s * TILE + j * BOX, &tdo, &full[s], 64 * j,
                            m0, h, b);
        }
        const long long row = (long long)(b * H + h) * Sp + m0;
        sm90::bulk_load(Ls + s * BM, lse2 + row, BM * 4, &full[s]);
        sm90::bulk_load(Ds + s * BM, delta + row, BM * 4, &full[s]);
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int w = tid / 128 - 1, t = tid % 128, lane = t % 32;
  const int k_lo = n0 + (SPLIT ? 0 : 64 * w);          // the consumer's keys
  const int c0 = SPLIT ? w * DC : 0;                   // and dK, dV columns
  const int key0 = k_lo + 16 * (t / 32) + lane / 4;    // this thread's: key0, key0 + 8
  const int c2 = 2 * (t % 4);
  uint8_t* Kw = Ks + (SPLIT ? 0 : w) * NB * BOX;
  uint8_t* Vw = Vs + (SPLIT ? 0 : w) * NB * BOX;
  const uint32_t k_base = sm90::smem_u32(Kw), v_base = sm90::smem_u32(Vw);

  float dk[DC / 2], dv[DC / 2], st[32], dpt[32];
  uint32_t pa[16];  // P^T, then dS^T, as the A operand
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;

  // the query tiles of a head this consumer computes, [j_lo, j_hi): the
  // causal rule hides a prefix, the window a suffix, keys past T all
  auto hidden = [&](int j) {
    const int m0 = m_begin + j * BM;
    return k_lo >= T || (causal && m0 + BM - 1 < k_lo) ||
           (window > 0 && m0 - (k_lo + 63) >= window);
  };
  int j_lo = 0, j_hi = nm;
  while (j_lo < j_hi && hidden(j_lo)) ++j_lo;
  while (j_hi > j_lo && hidden(j_hi - 1)) --j_hi;
  auto pass = [&](int i) {
    sm90::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    if (t == 0) sm90::mbar_arrive(&empty[i % STAGES]);
  };

  sm90::mbar_wait(&kv_full, 0);
  for (int hg = 0; hg < G; ++hg) {
    const int i0 = hg * nm;
    for (int j = 0; j < j_lo; ++j) pass(i0 + j);
    for (int j = j_lo; j < j_hi; ++j) {
      const int i = i0 + j, s = i % STAGES, m0 = m_begin + j * BM;
      const uint32_t q_base = sm90::smem_u32(Qs + s * TILE);
      const uint32_t do_base = sm90::smem_u32(dOs + s * TILE);
      sm90::mbar_wait(&full[s], (i / STAGES) & 1);
      // S^T = K Q^T: A = K (K-major), B = Q (K-major)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n64k16<0>(st, k_desc(k_base, kk, BOX),
                                 k_desc(q_base, kk, BOX), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();  // this tile's S^T and the last tile's dK
      sm90::fence_regs(st);
      sm90::fence_regs(dk);
      if (t == 0 && j > j_lo) sm90::mbar_arrive(&empty[(i - 1) % STAGES]);
      const bool edge = k_lo + 63 >= T || m0 + BM > S ||
                        (causal && k_lo + 63 > m0) ||
                        (window > 0 && m0 + BM - 1 - k_lo >= window);
      if (edge)
        p_tile_t<true>(st, Ls + s * BM, key0, m0, S, T, causal, window, sl2);
      else
        p_tile_t<false>(st, Ls + s * BM, key0, m0, S, T, causal, window, sl2);
      pack_a<64>(st, pa);  // P^T rounded to bf16 (V's dtype), as the forward
      // dV += P^T dO: A = P^T from registers, B = dO (N-major), 16 queries
      // a step; dP^T = V dO^T: A = V (K-major), B = dO (K-major)
      sm90::fence_regs(dv);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc) {
        const uint32_t a[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2],
                               pa[4 * kc + 3]};
        sm90::wgmma_m64k16_rs<DC, 1>(
            dv, a,
            sm90::desc_sw128(do_base + (c0 / 64) * BOX + kc * 16 * 128, BOX,
                             1024));
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n64k16<0>(dpt, k_desc(v_base, kk, BOX),
                                 k_desc(do_base, kk, BOX), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dpt);
      // dS^T = P^T (dP^T - Delta), in fp32 P as the plain version
      const float* Dt = Ds + s * BM;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = *reinterpret_cast<const float2*>(Dt + 8 * jj + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st[4 * jj + e] *= dpt[4 * jj + e] - (e & 1 ? dl.y : dl.x);
      }
      pack_a<64>(st, pa);
      // dK += dS^T Q: A = dS^T from registers, B = Q (N-major)
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc) {
        const uint32_t a[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2],
                               pa[4 * kc + 3]};
        sm90::wgmma_m64k16_rs<DC, 1>(
            dk, a,
            sm90::desc_sw128(q_base + (c0 / 64) * BOX + kc * 16 * 128, BOX,
                             1024));
      }
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dk);
    if (t == 0 && j_hi > j_lo)
      sm90::mbar_arrive(&empty[(i0 + j_hi - 1) % STAGES]);
    for (int j = j_hi; j < nm; ++j) pass(i0 + j);
  }

  // Epilogue: dK = scale dS^T Q and dV as bf16 into the consumer's K and V
  // boxes (the other consumer may still read them at D = 256), in their
  // swizzle (a row's 16-byte chunk c sits at c ^ (row % 8)), then out by
  // TMA; keys past T are not written.
  sm90::bar_sync(1, 256);
  uint8_t* outk = Kw + (c0 / 64) * BOX;
  uint8_t* outv = Vw + (c0 / 64) * BOX;
  const int rr = 16 * (t / 32) + lane / 4, g = lane / 4;
#pragma unroll
  for (int i = 0; i < DC / 2; i += 2) {
    const int r = (i >> 1) & 1;
    const int at = (i / 32) * BOX + (rr + 8 * r) * 128 +
                   (((i / 4) % 8) ^ g) * 16 + (lane % 4) * 4;
    *reinterpret_cast<__nv_bfloat162*>(outk + at) =
        __floats2bfloat162_rn(dk[i] * scale, dk[i + 1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(outv + at) =
        __floats2bfloat162_rn(dv[i], dv[i + 1]);
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(2 + w, 128);
  if (t == 0 && k_lo < T) {
    for (int j = 0; j < DC / 64; ++j) {
      sm90::tma_store_4d(&tdk, outk + j * BOX, c0 + 64 * j, k_lo, hk, b);
      sm90::tma_store_4d(&tdv, outv + j * BOX, c0 + 64 * j, k_lo, hk, b);
    }
    sm90::tma_store_commit();
    sm90::tma_store_wait<0>();
  }
}

// The dQ consumer's tile in the S layout (rows row0 + 8 ((i >> 1) & 1),
// columns keys kv0 + 8 (i >> 2) + 2 (t % 4) + (i & 1)): P from S in `sc`,
// the mask tested only on an EDGE tile, then dS = P (dP - Delta) into sc
template <bool EDGE, int N>
__device__ __forceinline__ void ds_tile(float (&sc)[N / 2],
                                        const float (&dp)[N / 2],
                                        const float (&l2)[2],
                                        const float (&dl)[2], int row0,
                                        int kv0, int S, int T, int causal,
                                        int window, float sl2) {
  const int c2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = sm90::exp2_approx(fmaf(sc[i], sl2, -l2[r]));
    if constexpr (EDGE)
      p = visible(row0 + 8 * r, kv0 + 8 * (i >> 2) + c2 + (i & 1), S, T,
                  causal, window)
              ? p
              : 0.f;
    sc[i] = p * (dp[i] - dl[r]);
  }
}

// dQ for query rows [q0, q0 + 128) of head h of batch b: a block of
// flash_bwd_wgmma in its dQ role. Shared memory: Q and dO as
// [consumer][D/64] boxes of 64 rows, the ring of K and V tiles as [D/64]
// boxes of BKV rows.
template <int D>
__device__ __forceinline__ void dq_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const CUtensorMap& tdq,
    const float* __restrict__ lse2, const float* __restrict__ delta, int H,
    int KV, int S, int Sp, int T, int causal, int window, float sl2,
    float scale, int q0, int b, int h, uint8_t* smem_raw) {
  constexpr int NB = D / 64, BOX = wg::BOX, BQ = wg::BQ;
  constexpr int BKV = wg::q_keys(D), STAGES = wg::q_stages(D);
  constexpr int KBOX = BKV * 128, KVB = BKV * D * 2;
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* dOs = Qs + BQ * D * 2;
  uint8_t* Ks = dOs + BQ * D * 2;
  uint8_t* Vs = Ks + STAGES * KVB;
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];

  const int tid = threadIdx.x;
  const int hk = h / (H / KV);
  // the block's KV tiles: those any of its rows may see
  const int t_end = causal ? min(T, q0 + BQ) : T;
  const int t_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + BKV - 1) / BKV : 0;

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 2 * BQ * D * 2);
      for (int j = 0; j < 2 * NB; ++j) {
        sm90::tma_load_4d(Qs + j * BOX, &tq, &q_full, 64 * (j % NB),
                          q0 + 64 * (j / NB), h, b);
        sm90::tma_load_4d(dOs + j * BOX, &tdo, &q_full, 64 * (j % NB),
                          q0 + 64 * (j / NB), h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kv0 = t_begin + i * BKV;
        if (i >= STAGES) sm90::mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * KVB);
        for (int j = 0; j < NB; ++j) {
          sm90::tma_load_4d(Ks + s * KVB + j * KBOX, &tk, &full[s], 64 * j,
                            kv0, hk, b);
          sm90::tma_load_4d(Vs + s * KVB + j * KBOX, &tv, &full[s], 64 * j,
                            kv0, hk, b);
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const int w = tid / 128 - 1, t = tid % 128, lane = t % 32;
  const int r_lo = q0 + 64 * w;                      // the warpgroup's rows
  const int row0 = r_lo + 16 * (t / 32) + lane / 4;  // this thread's: row0, row0 + 8
  uint8_t* Qw = Qs + w * NB * BOX;
  const uint32_t q_base = sm90::smem_u32(Qw);
  const uint32_t do_base = sm90::smem_u32(dOs + w * NB * BOX);
  const long long row_base = (long long)(b * H + h) * Sp;
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row0 + 8 * r < S;
    l2[r] = in ? lse2[row_base + row0 + 8 * r] : 0.f;
    dl[r] = in ? delta[row_base + row0 + 8 * r] : 0.f;
  }

  float dq[D / 2], sc[BKV / 2], dp[BKV / 2];
  uint32_t pa[BKV / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // the tiles this warpgroup computes, [i_lo, i_hi): the window hides a
  // prefix of the block's tiles from its rows, the causal rule a suffix
  auto hidden = [&](int i) {
    const int kv0 = t_begin + i * BKV;
    return r_lo >= S || (causal && kv0 > r_lo + 63) ||
           (window > 0 && r_lo - (kv0 + BKV - 1) >= window);
  };
  int i_lo = 0, i_hi = n_tiles;
  while (i_lo < i_hi && hidden(i_lo)) ++i_lo;
  while (i_hi > i_lo && hidden(i_hi - 1)) --i_hi;
  auto pass = [&](int i) {
    sm90::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    if (t == 0) sm90::mbar_arrive(&empty[i % STAGES]);
  };

  sm90::mbar_wait(&q_full, 0);
  for (int i = 0; i < i_lo; ++i) pass(i);
  for (int i = i_lo; i < i_hi; ++i) {
    const int s = i % STAGES, kv0 = t_begin + i * BKV;
    const uint32_t k_base = sm90::smem_u32(Ks + s * KVB);
    const uint32_t v_base = sm90::smem_u32(Vs + s * KVB);
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    // S = Q K^T and dP = dO V^T: every operand K-major
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_m64k16_ss<BKV>(sc, k_desc(q_base, kk, BOX),
                                 k_desc(k_base, kk, KBOX), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::wgmma_m64k16_ss<BKV>(dp, k_desc(do_base, kk, BOX),
                                 k_desc(v_base, kk, KBOX), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // these and the last tile's dQ
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::fence_regs(dq);
    if (t == 0 && i > i_lo) sm90::mbar_arrive(&empty[(i - 1) % STAGES]);
    const bool edge = kv0 + BKV > T || (causal && kv0 + BKV - 1 > r_lo) ||
                      (window > 0 && r_lo + 63 - kv0 >= window);
    if (edge)
      ds_tile<true, BKV>(sc, dp, l2, dl, row0, kv0, S, T, causal, window, sl2);
    else
      ds_tile<false, BKV>(sc, dp, l2, dl, row0, kv0, S, T, causal, window, sl2);
    pack_a<BKV>(sc, pa);
    // dQ += dS K: A = dS from registers, B = K (N-major), 16 keys a step
    sm90::fence_regs(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      const uint32_t a[4] = {pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2],
                             pa[4 * kc + 3]};
      sm90::wgmma_m64k16_rs<D, 1>(
          dq, a, sm90::desc_sw128(k_base + kc * 16 * 128, KBOX, 1024));
    }
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dq);
  if (t == 0 && i_hi > i_lo) sm90::mbar_arrive(&empty[(i_hi - 1) % STAGES]);
  for (int i = i_hi; i < n_tiles; ++i) pass(i);

  // Epilogue: dQ = scale dS K as bf16 into this warpgroup's Q boxes, in
  // their swizzle, then out by TMA; rows past S are not written.
  sm90::bar_sync(2 + w, 128);  // every warp's wgmma has done reading Q
  const int rr = row0 - r_lo, g = lane / 4;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i >> 1) & 1;
    *reinterpret_cast<__nv_bfloat162*>(
        Qw + (i / 32) * BOX + (rr + 8 * r) * 128 + (((i / 4) % 8) ^ g) * 16 +
        (lane % 4) * 4) = __floats2bfloat162_rn(dq[i] * scale, dq[i + 1] * scale);
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(2 + w, 128);
  if (t == 0 && r_lo < S) {
    for (int j = 0; j < NB; ++j)
      sm90::tma_store_4d(&tdq, Qw + j * BOX, 64 * j, r_lo, h, b);
    sm90::tma_store_commit();
    sm90::tma_store_wait<0>();
  }
}

// Both wgmma roles in one launch, so that dQ blocks fill the SMs that
// dK/dV blocks leave idle (under the causal rule most of them): blocks
// [0, n_kv) take a (key tile, batch, KV head) each, key tiles in order,
// the heaviest causal ones first; the others a (query tile, batch, head)
// each, the last query tiles first.
template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdk,
                const __grid_constant__ CUtensorMap tdv,
                const __grid_constant__ CUtensorMap tkq,
                const __grid_constant__ CUtensorMap tvq,
                const __grid_constant__ CUtensorMap tdq,
                const float* __restrict__ lse2,
                const float* __restrict__ delta, int B, int H, int KV, int S,
                int Sp, int T, int causal, int window, float sl2,
                float scale) {
  extern __shared__ uint8_t smem_raw[];
  const int id = blockIdx.x;
  const int n_kv = (T + wg::kv_keys(D) - 1) / wg::kv_keys(D) * B * KV;
  if (id < n_kv) {
    const int bk = id % (B * KV);
    dkv_block<D>(tq, tk, tv, tdo, tdk, tdv, lse2, delta, H, KV, S, Sp, T,
                 causal, window, sl2, scale, id / (B * KV) * wg::kv_keys(D),
                 bk / KV, bk % KV, smem_raw);
  } else {
    const int j = id - n_kv, bh = j % (B * H);
    const int q_tiles = (S + wg::BQ - 1) / wg::BQ;
    dq_block<D>(tq, tkq, tvq, tdo, tdq, lse2, delta, H, KV, S, Sp, T, causal,
                window, sl2, scale, (q_tiles - 1 - j / (B * H)) * wg::BQ,
                bh / H, bh % H, smem_raw);
  }
}

void launch_delta(const void* o, const void* d_o, const float* lse,
                  float* delta, float* lse2, int B, int H, int S, int Sp,
                  int D, const long long* os, const long long* ds,
                  cudaStream_t stream) {
  const long long rows = (long long)B * H * Sp;
  const unsigned blocks = (unsigned)((rows * (D / 8) + 255) / 256);
  flash_bwd_delta<<<blocks, 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(d_o), lse, delta,
      lse2, H, S, Sp, D, os[0], os[1], os[2], ds[0], ds[1], ds[2], rows);
}

// Returns a cudaError_t, or -(CUresult) when a tensor map cannot be made.
// `scratch` holds Delta, then lse * log2(e), each (B, H, Sp) fp32.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* d_o, const float* lse, float* scratch, void* dq,
                 void* dk, void* dv, int B, int H, int KV, int S, int T,
                 const long long* qs, const long long* ks, const long long* vs,
                 const long long* os, const long long* ds, int causal,
                 int window, float scale, cudaStream_t stream) {
  if (!sm90::encode_fn()) return cudaErrorNotSupported;
  const int Sp = (S + 63) / 64 * 64;
  float* delta = scratch;
  float* lse2 = scratch + (long long)B * H * Sp;
  const long long qo[3] = {(long long)H * S * D, (long long)S * D, D};
  const long long ko[3] = {(long long)KV * T * D, (long long)T * D, D};
  const int bkv = wg::q_keys(D);
  CUtensorMap tq, tdo, tk, tv, tkq, tvq, tdq, tdk, tdv;
  CUresult r = sm90::encode_4d(&tq, q, D, S, H, B, qs, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tdo, d_o, D, S, H, B, ds, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tk, k, D, T, KV, B, ks, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tv, v, D, T, KV, B, vs, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tkq, k, D, T, KV, B, ks, bkv);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tvq, v, D, T, KV, B, vs, bkv);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tdq, dq, D, S, H, B, qo, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tdk, dk, D, T, KV, B, ko, 64);
  if (r == CUDA_SUCCESS) r = sm90::encode_4d(&tdv, dv, D, T, KV, B, ko, 64);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const int smem =
      wg::kv_smem(D) > wg::q_smem(D) ? wg::kv_smem(D) : wg::q_smem(D);
  // once per instantiation, outside any CUDA-graph capture of later calls
  static cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  launch_delta(o, d_o, lse, delta, lse2, B, H, S, Sp, D, os, ds, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long blocks =
      (long long)(T + wg::kv_keys(D) - 1) / wg::kv_keys(D) * B * KV +
      (long long)(S + wg::BQ - 1) / wg::BQ * B * H;
  flash_bwd_wgmma<D><<<(unsigned)blocks, wg::THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, tkq, tvq, tdq, lse2, delta, B, H, KV, S, Sp,
      T, causal, window, scale * LOG2E, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- mma_sync

namespace ms {
constexpr int WARPS = 4, PAD = 8;
constexpr int BN = 64;  // keys of a dK/dV block, 16 a warp; keys a dQ step
constexpr int BM = 64;  // query rows of a dK/dV step and of a dQ block
template <int D>
constexpr int dkv_smem = (2 * BN + 2 * BM) * (D + PAD) * 2 + 2 * BM * 4;
template <int D>
constexpr int dq_smem = (2 * BM + 2 * BN) * (D + PAD) * 2;
}  // namespace ms

// rows [r0, r0 + rows) of a (rows, D) slab with row stride `rs` into
// shared memory [rows][D + PAD], zeros past `n` valid rows
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int r0, int rows,
                                          int n) {
  constexpr int LD = D + ms::PAD;
  for (int v = threadIdx.x; v < rows * D / 8; v += ms::WARPS * 32) {
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
  constexpr int LD = D + ms::PAD;
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
// rows of `b`, D columns): O += P V's form
template <int D, int NJ>
__device__ __forceinline__ void mma_p(float (&acc)[D / 8][4],
                                      const float (&p)[NJ][4], const bf16* b) {
  constexpr int LD = D + ms::PAD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < NJ / 2; ++kc) {
    const uint32_t af[4] = {pack_f32(p[2 * kc][0], p[2 * kc][1]),
                            pack_f32(p[2 * kc][2], p[2 * kc][3]),
                            pack_f32(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_f32(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    const bf16* pb = b + (kc * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t bf[2] = {pack_bf16(pb[i * 8], pb[LD + i * 8]),
                              pack_bf16(pb[8 * LD + i * 8], pb[9 * LD + i * 8])};
      mma_bf16_16816(acc[i], af, bf);
    }
  }
}

// dK, dV for keys [n0, n0 + BN) of KV head hk: grid (key tiles, B * KV).
// Warp w owns keys n0 + 16 w + (0..15), all D columns.
template <int D>
__global__ void __launch_bounds__(ms::WARPS * 32)
flash_bwd_dkv(const bf16* __restrict__ Q, const bf16* __restrict__ K,
              const bf16* __restrict__ V, const bf16* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dK, bf16* __restrict__ dV, int H, int KV,
              int S, int T, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, long long dsb, long long dsh,
              long long dss, int causal, int window, float scale) {
  constexpr int LD = D + ms::PAD, BN = ms::BN, BM = ms::BM;
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
  const int key0 = n0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float sl2 = scale * LOG2E;

  load_tile<D>(Ks, K + b * ksb + hk * ksh, kss, n0, BN, T);
  load_tile<D>(Vs, V + b * vsb + hk * vsh, vss, n0, BN, T);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
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
      for (int r = threadIdx.x; r < BM; r += ms::WARPS * 32) {
        const bool in = m0 + r < S;
        Ls[r] = in ? lse[row_base + m0 + r] * LOG2E : 0.f;
        Ds[r] = in ? delta[row_base + m0 + r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T, then P^T = exp(s - lse) on the visible pairs
      float pt[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) pt[j][0] = pt[j][1] = pt[j][2] = pt[j][3] = 0.f;
      mma_rows<D, BM / 8>(pt, Ks + warp * 16 * LD, Qs);
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
      mma_p<D, BM / 8>(dv, pt, dOs);
      // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta)
      float dst[BM / 8][4];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) dst[j][0] = dst[j][1] = dst[j][2] = dst[j][3] = 0.f;
      mma_rows<D, BM / 8>(dst, Vs + warp * 16 * LD, dOs);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[j][e] = pt[j][e] * (dst[j][e] - Ds[j * 8 + 2 * t + (e & 1)]);
      // dK += dS^T Q
      mma_p<D, BM / 8>(dk, dst, Qs);
    }
  }

  // out: dK = scale dS^T Q and dV, bf16, (B, KV, T, D) contiguous
  const long long base = ((long long)(b * KV + hk) * T) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
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

// dQ for query rows [q0, q0 + BM) of head h: grid (query tiles, B * H);
// warp w owns rows q0 + 16 w + (0..15)
template <int D>
__global__ void __launch_bounds__(ms::WARPS * 32)
flash_bwd_dq(const bf16* __restrict__ Q, const bf16* __restrict__ K,
             const bf16* __restrict__ V, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dQ, int H, int KV, int S, int T,
             long long qsb, long long qsh, long long qss, long long ksb,
             long long ksh, long long kss, long long vsb, long long vsh,
             long long vss, long long dsb, long long dsh, long long dss,
             int causal, int window, float scale) {
  constexpr int LD = D + ms::PAD, BQ = ms::BM, BN = ms::BN;
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
    mma_p<D, BN / 8>(dq, ds, Ks);
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

// `scratch` holds Delta, (B, H, S) fp32
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* d_o, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int H, int KV, int S, int T, const long long* qs,
                       const long long* ks, const long long* vs,
                       const long long* os, const long long* ds, int causal,
                       int window, float scale, cudaStream_t stream) {
  // once per instantiation, outside any CUDA-graph capture of later calls
  static cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ms::dkv_smem<D>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ms::dq_smem<D>);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const auto* Q = static_cast<const bf16*>(q);
  const auto* K = static_cast<const bf16*>(k);
  const auto* V = static_cast<const bf16*>(v);
  const auto* dO = static_cast<const bf16*>(d_o);
  launch_delta(o, d_o, lse, delta, nullptr, B, H, S, S, D, os, ds, stream);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkv<D><<<dim3((T + ms::BN - 1) / ms::BN, B * KV), ms::WARPS * 32,
                     ms::dkv_smem<D>, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, KV, S, T, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], ds[0], ds[1], ds[2], causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq<D><<<dim3((S + ms::BM - 1) / ms::BM, B * H), ms::WARPS * 32,
                    ms::dq_smem<D>, stream>>>(
      Q, K, V, dO, lse, delta, static_cast<bf16*>(dq), H, KV, S, T, qs[0],
      qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], ds[0], ds[1],
      ds[2], causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, do: (B,H,S,D); k, v: (B,KV,T,D), each given by element strides
// (batch, head, row) with unit stride along D; lse: (B,H,S) fp32, the
// forward's row log-sum-exp; scratch: fp32, (B,H,S) on the mma_sync route
// and 2 x (B,H,Sp), Sp = S rounded up to 64, on the wgmma route; dq
// (B,H,S,D) and dk, dv (B,KV,T,D) contiguous outputs. `route` is the
// caller's choice (kernels/flash_attention.py BWD_ROUTES): 0 wgmma for D
// in {64, 128, 256}, 1 mma_sync for D in {16, 32}. Returns the cudaError_t
// of the launches (0 on success), or -(CUresult) when a TMA tensor map
// cannot be made. The caller has checked H % KV == 0, 16-byte alignment
// of pointers and strides, and S, T > 0.
extern "C" int repro_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* d_o, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int B, int H, int KV, int S, int T, int D, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, long long dsb, long long dsh, long long dss, int causal,
    int window, float scale, int route, void* stream) {
  const long long qs[3] = {qsb, qsh, qss}, ks[3] = {ksb, ksh, kss},
                  vs[3] = {vsb, vsh, vss}, os[3] = {osb, osh, oss},
                  ds[3] = {dsb, dsh, dss};
  const float* L = static_cast<const float*>(lse);
  float* X = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route * 1000 + D) {
#define REPRO_FA_BWD(fn, d, code)                                          \
  case code:                                                               \
    return fn<d>(q, k, v, o, d_o, L, X, dq, dk, dv, B, H, KV, S, T, qs, ks, \
                 vs, os, ds, causal, window, scale, s);
    REPRO_FA_BWD(launch_wgmma, 64, 64)
    REPRO_FA_BWD(launch_wgmma, 128, 128)
    REPRO_FA_BWD(launch_wgmma, 256, 256)
    REPRO_FA_BWD(launch_mma, 16, 1016)
    REPRO_FA_BWD(launch_mma, 32, 1032)
#undef REPRO_FA_BWD
    default:
      return cudaErrorInvalidValue;
  }
}
