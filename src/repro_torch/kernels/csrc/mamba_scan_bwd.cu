// The backward pass of the selective scan (mamba_scan.cu), fp32 state:
// with a_t = exp(dt_t A), u_t = dt_t x_t and g_t the gradient of h_t,
//   g_t = dy_t C_t + a_{t+1} g_{t+1}      (from dh_last, or 0),
//   dC_t = sum_d dy_{t,d} h_{t,d}         dB_t = sum_d g_{t,d} u_{t,d}
//   du_t = sum_n g_{t,n} B_{t,n}          dx_t = dt_t du_t
//   d dt_t = sum_n g_{t,n} A_n a_{t,n} h_{t-1,n} + x_t du_t
//   dA = sum_{b,t} g_t dt_t a_t h_{t-1}
// dt, x, dy: (Bt,S,D); A: (D,N); B, C: (Bt,S,N); dh_last (Bt,D,N) or
// null; x, dy and dx bf16 or fp32, the rest fp32.
//
// Replaces no TPU kernel: the reference differentiates its chunked
// associative scan (src/repro/models/mamba.py:96-125) through XLA, and
// its Pallas scan (src/repro/kernels/mamba_scan.py:27) has no backward
// pass. It lets falcon-mamba-7b train on the card.
//
// What bounds it on an H100: per (b, t, d) it reads dt, x and dy and
// writes d dt and dx (14 bytes in bf16: 117 MB, 0.035 ms, at the
// microbatch shape (1, 1024, 8192, 16)); per state-step it needs one
// exponential (134 M there: 0.032 ms at 16 a clock per SM) and about 12
// FP32 instructions (the forward's recompute, then g, the dB, dC and du
// partials, a h, g a h, the d dt and dA sums and the carry a g: 0.048 ms
// at one instruction a clock per 32 lanes). So the FP32 pipes bound it,
// with the memory and the MUFUs close behind. What each step must wait
// for is short: only the carry r = a g and g = dy C + r depend on the step
// before; everything else a step does is throughput work.
//
// Design (three launches a call):
//   * The forward's lane layout: G = NP / 4 lanes a channel, 4 states
//     each, CB = 128 / G channels a block of 128 threads.
//   * Parallel over time. S is cut into `segments` of `seg_chunks` whole
//     16-step chunks; a block takes one (batch row, channel block,
//     segment). The states need nothing from other segments: the forward
//     saved the state at every chunk start. The carry of g into a segment
//     comes from the steps after it, so a pre-pass
//     (`mamba_scan_bwd_carry`) cuts those steps into short pieces (at most
//     4 chunks, dividing a segment) and, a block a piece, writes the
//     carry the piece hands back from no carry in, r0 = sum_t exp(A cs_t)
//     dy_t C_t (cs_t: the sum of dt over the piece up to t, so a piece's
//     decays are one exponential each and no rounding compounds over its
//     steps), and its sum of dt. A segment's block then folds the pieces
//     after it into its carry, the last first: R = r0 + exp(A sum dt) R,
//     from dh_last, with no grid-wide sync. The pre-pass's exponential is
//     `ex2.approx` (libdevice `expf` there was slower and no closer to an
//     fp64 truth); its error reaches the grads only through the carry.
//   * Saved states, not stored history: walking its chunks in reverse, a
//     lane recomputes the chunk's states and decays from the chunk's
//     saved state in two halves of 8 steps: steps 0-7 keep their decays,
//     in shared memory, steps 8-15 their decays and states in registers;
//     g runs back through 15..8; the states of 0-7 come back from the kept
//     decays (two FP32 instructions a state-step, no exponential) and g
//     runs on through 7..0. So at most 17 of a chunk's per-state arrays
//     are live in registers. a_t is libdevice's expf(dt A), as in the
//     forward's training instance, so the recomputed states are the
//     forward's bits (serving's ex2.approx there put the grads 3 to 4x
//     farther from an fp64 truth than the plain version's).
//   * No producer warp: the block's threads bring in the next chunk's
//     dt, x, dy, B, C and saved states themselves with 16-byte cp.async
//     into a double buffer while they work on this one (zero-filled past
//     S, D and N; element by element where rows are not 16-byte aligned).
//   * dB and dC: each step a lane's 4 dB and 4 dC values are summed over
//     the warp's channels by halving shuffle rounds (one value a lane
//     left) and stored to shared memory; after each half-chunk the block
//     meets at one barrier and adds the warps' sums in a fixed order into
//     its rows of the workspace. d dt and du: each step a lane stores its
//     two partials; after the half-chunk a thread a (step, channel) adds
//     its channel's G lanes in order and stores d dt and dx, a row of the
//     block's channels a step.
//   * No two blocks add into one element: each block writes its dB and dC
//     partials to its own rows of a workspace, (blocks, Bt, S, 2, NP),
//     segments covering disjoint steps, and its dA partial to a (D, NP)
//     slice of its (batch row, segment). `mamba_scan_bwd_sum` adds them
//     in a fixed order, so two calls give the same bits.
//   * Registers and residency: __launch_bounds__(128, 4) (128 registers a
//     thread, 16 warps an SM) where 4 blocks fit in shared memory (56 KB
//     a block at NP = 16 and bf16: 2 stages, a buffer of sums for each
//     half, the stashed decays), else (128, 2).
//   * Padding is arithmetic, as in the forward: states past N have A =
//     B = C = 0 and g = 0; channels past D and steps past S read zeros,
//     so a = 1 carries g through them unchanged; only stores are masked.
//   * The launches are planned in Python (`mamba_scan.plan_bwd`), and this
//     side refuses a plan that does not match the instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace scan;

constexpr int THREADS = 128;      // a block: THREADS / G channels, G lanes each
constexpr int WARPS = THREADS / 32;
constexpr int SPL = 4;            // states a lane
constexpr int HALF = CHUNK / 2;   // steps a recompute keeps; summed at once
constexpr int STASH = 8;          // of which decays wait in shared memory
constexpr int SMEM_BLOCK = 232448;   // what one block may use (227 KB)
constexpr int SMEM_SM = 233472;      // an SM's, 1 KB of it kept a block
constexpr int SUM_OUT = 32;       // the summing kernel: outputs a block,
constexpr int SUM_SLICES = 8;     // each summed in this many strided slices
constexpr int SUM_THREADS = SUM_OUT * SUM_SLICES;

// The main kernel's shared memory for (NP, T).
template <int NP, typename T>
struct Layout {
  static constexpr int G = NP / SPL;
  static constexpr int CB = THREADS / G;
  // one chunk: dt [CHUNK][CB], B and C [CHUNK][NP], the saved states
  // [CB][NP] (fp32), then x and dy [CHUNK][CB] (T)
  static constexpr int STAGE =
      CHUNK * (CB * (4 + 2 * (int)sizeof(T)) + 2 * NP * 4) + CB * NP * 4;
  // a half-chunk's sums: the warps' dB and dC [HALF][WARPS][2][NP], then
  // the lanes' d dt and du partials [HALF][2][THREADS]; one such buffer
  // for each half
  static constexpr int WSUM = HALF * WARPS * 2 * NP;
  static constexpr int PART = WSUM + HALF * 2 * THREADS;
  // then each thread's decays of steps 0 .. STASH - 1, [STASH][THREADS][SPL]
  static constexpr int BYTES =
      2 * STAGE + 2 * PART * 4 + STASH * THREADS * SPL * 4;
  // a lane's dB and dC values after the warp's reduction (below)
  static constexpr int K = 2 * SPL * G / 32 > 1 ? 2 * SPL * G / 32 : 1;
  // the register bound: 4 blocks an SM (128 registers a thread) where 4
  // fit in shared memory, else 2
  static constexpr int BLOCKS = 4 * (BYTES + 1024) <= SMEM_SM ? 4 : 2;
  static_assert(NP % SPL == 0 && THREADS % G == 0 && CB % 8 == 0 &&
                STAGE % 16 == 0 && STASH <= HALF && K <= SPL, "layout");
};

__device__ __forceinline__ void load4(float (&v)[SPL], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[SPL]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// p[0] + p[1] + ... + p[n - 1], in that order (16-byte loads where n
// allows)
template <int n>
__device__ __forceinline__ float sum_in_order(const float* p) {
  float v[n];
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int i = 0; i < n; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = p[i];
  }
  float s = v[0];
#pragma unroll
  for (int i = 1; i < n; ++i) s += v[i];
  return s;
}

// A tile of ROWS rows into shared memory as [ROWS][W], by the whole block:
// row r is `src + r * ld` from column `c0`; zeros past `valid_rows` rows
// and past column `cols`. 16-byte cp.async copies when `vec` (16-byte
// aligned rows), else element by element.
template <int ROWS, int W, typename E>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, int valid_rows,
                                          long long ld, int c0, int cols,
                                          bool vec) {
  if (vec && valid_rows >= ROWS && c0 + W <= cols) {   // a whole tile
    constexpr int V = 16 / sizeof(E);
    constexpr int CW = W / V;
#pragma unroll
    for (int it = 0; it < (ROWS * CW + THREADS - 1) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if ((ROWS * CW) % THREADS == 0 || i < ROWS * CW)
        cp_async16(sm90::smem_u32(dst + i * V), src + (i / CW) * ld + c0 +
                   (i % CW) * V, 16);
    }
  } else if (vec) {
    constexpr int V = 16 / sizeof(E);
    constexpr int CW = W / V;  // 16-byte pieces a row
    static_assert(W % V == 0, "row width");
#pragma unroll
    for (int it = 0; it < (ROWS * CW + THREADS - 1) / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if ((ROWS * CW) % THREADS == 0 || i < ROWS * CW) {
        const int r = i / CW, q = i % CW;
        const int n = r < valid_rows ? min(max(cols - c0 - q * V, 0), V) : 0;
        const E* s = n ? src + r * ld + c0 + q * V : src;
        cp_async16(sm90::smem_u32(dst + r * W + q * V), s, n * (int)sizeof(E));
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += THREADS) {
      const int r = i / W, c = i % W;
      dst[i] = (r < valid_rows && c0 + c < cols) ? src[r * ld + c0 + c]
                                                 : zero<E>();
    }
  }
}

template <typename E>
__device__ __forceinline__ bool rows16(const E* p, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         width % (16 / (int)sizeof(E)) == 0;
}

// Where a lane's values land after `reduce_channels<G, 2 SPL>` (halving
// rounds over the xor masks 16, 8, ..., G while a lane holds two values
// or more): the index of its first value, a function of the lane alone.
template <int G>
__device__ __forceinline__ int first_value(int lane) {
  constexpr int V = 2 * SPL;
  int first = 0;
#pragma unroll
  for (int m = 16; m >= G; m /= 2) {
    const int n = V * m / 16;
    if (n >= 2 && (lane & m)) first += n / 2;
  }
  return first;
}

// One step's g, back through step j of the chunk (slot jj of its half's
// buffer `pb`): the lane's 4 decays `a`, states before (`hp`) and after
// (`hc`) the step; updates the carry r and dA. Its dB and dC values are
// summed over the warp's channels by halving shuffle rounds and the
// lane's K sums stored at `wpos` of the warp's row (a lane whose sums
// another lane also holds stores the same values to the same place);
// its d dt and du partials go to the half's buffer.
template <int NP, typename T>
__device__ __forceinline__ void back_step(
    int j, int jj, const float (&a)[SPL], const float (&hp)[SPL],
    const float (&hc)[SPL], const float (&an)[SPL], float (&r)[SPL],
    float (&dA)[SPL], const float* sdt, const float* sB, const float* sC,
    const T* sx, const T* sdy, float* pb, int wpos, int c, int g) {
  using L = Layout<NP, T>;
  const float dtv = sdt[j * L::CB + c];
  const float u = dtv * to_f32(sx[j * L::CB + c]);
  const float dyv = to_f32(sdy[j * L::CB + c]);
  float bv[SPL], cv[SPL], v[2 * SPL];
  load4(bv, sB + j * NP + g * SPL);
  load4(cv, sC + j * NP + g * SPL);
  float du = 0.f, sa = 0.f;
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const float gs = fmaf(dyv, cv[s], r[s]);
    r[s] = a[s] * gs;                // the carry into step j - 1
    const float t1 = r[s] * hp[s];   // g a h_{t-1}
    v[s] = gs * u;                   // dB
    v[SPL + s] = dyv * hc[s];        // dC
    du = fmaf(gs, bv[s], du);
    sa = fmaf(t1, an[s], sa);
    dA[s] = fmaf(t1, dtv, dA[s]);
  }
  float* sd = pb + L::WSUM + jj * 2 * THREADS + threadIdx.x;
  sd[0] = sa;
  sd[THREADS] = du;
  reduce_channels<L::G, 2 * SPL>(v, threadIdx.x % 32);
  float* w = pb + jj * WARPS * 2 * NP + wpos;
#pragma unroll
  for (int i = 0; i < L::K; ++i) w[i] = v[i];
}

// After the barrier: a half-chunk's sums in `pb` (steps j0 .. j0 + HALF
// - 1 of chunk k) added in a fixed order: dB and dC over the warps, into
// the block's rows of the workspace (`wsb`: (S, 2, NP)); d dt and du
// over a channel's G lanes, then d dt and dx stored (`ddt`, `ddx`: the
// block's channels at step 0), a row of the block's channels a step.
template <int NP, typename T>
__device__ __forceinline__ void sum_half(const float* pb, int t0, int S,
                                         int D, int d0, const float* sdt,
                                         const T* sx, int j0,
                                         float* __restrict__ wsb,
                                         float* __restrict__ ddt,
                                         T* __restrict__ ddx) {
  using L = Layout<NP, T>;
  constexpr int G = L::G, CB = L::CB;
  constexpr int OUT = HALF * 2 * NP;   // (step, dC, state)
#pragma unroll
  for (int it = 0; it < (OUT + THREADS - 1) / THREADS; ++it) {
    const int o = threadIdx.x + it * THREADS;
    if (OUT % THREADS == 0 || o < OUT) {
      const int jj = o / (2 * NP), e = o % (2 * NP);
      const float* p = pb + jj * WARPS * 2 * NP + e;
      float v = p[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v += p[w * 2 * NP];
      if (t0 + jj < S) wsb[(size_t)(t0 + jj) * 2 * NP + e] = v;
    }
  }
  const float* sd = pb + L::WSUM;
  constexpr int ITEMS = HALF * CB;     // (step, channel)
#pragma unroll
  for (int it = 0; it < (ITEMS + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (ITEMS % THREADS == 0 || i < ITEMS) {
      const int jj = i / CB, c = i % CB;
      const float* ps = sd + jj * 2 * THREADS + c * G;
      const float sa = sum_in_order<G>(ps), du = sum_in_order<G>(ps + THREADS);
      if (t0 + jj < S && d0 + c < D) {
        const size_t off = (size_t)(t0 + jj) * D + c;
        ddt[off] = fmaf(to_f32(sx[(j0 + jj) * CB + c]), du, sa);
        store(ddx + off, sdt[(j0 + jj) * CB + c] * du);
      }
    }
  }
}

// The pre-pass: for piece p (of `piece_chunks` chunks) of (batch row b,
// channel block blk), from the first piece after the first segment on,
// the carry it hands back from no carry in, r0 = sum_t P_t dy_t C_t with
// P_t = exp(A cs_t), cs_t the sum of dt over the piece's steps up to t
// (a_{t0} ... a_t as one exponential, so no error compounds over the
// steps), walked forward through its chunks staged with cp.async; writes
// r0 ((Bt, pieces, D, NP)) and the piece's sum of dt ((Bt, pieces, D)).
// The pieces of the first segment are never written: they hand their
// carry to no one. The decays by ex2.approx on A log2(e).
template <int NP, typename T>
__global__ void __launch_bounds__(THREADS)
mamba_scan_bwd_carry(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ Cm, const T* __restrict__ dy,
                     float* __restrict__ carry, float* __restrict__ seg_dt,
                     int S, int D, int N, int piece_chunks, int pieces,
                     int first_piece) {
  constexpr int G = NP / SPL, CB = THREADS / G;
  constexpr int TILE = CHUNK * (CB * (4 + (int)sizeof(T)) + NP * 4);
  __shared__ __align__(16) unsigned char tiles[2][TILE];
  const int nblk = (D + CB - 1) / CB;
  const int blk = blockIdx.x % nblk;
  const int piece =
      first_piece + (int)(blockIdx.x / nblk % (pieces - first_piece));
  const int b = (int)(blockIdx.x / nblk / (pieces - first_piece));
  const int d0 = blk * CB;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int d = d0 + c;
  const int nch = (S + CHUNK - 1) / CHUNK;
  const int k0 = piece * piece_chunks, k1 = min(k0 + piece_chunks, nch);
  const bool vdt = rows16(dt, D), vc = rows16(Cm, N), vdy = rows16(dy, D);
  auto load = [&](int k, unsigned char* st) {
    float* sdt = reinterpret_cast<float*>(st);
    float* sC = sdt + CHUNK * CB;
    T* sdy = reinterpret_cast<T*>(sC + CHUNK * NP);
    const int valid = min(CHUNK, S - k * CHUNK);
    const long long row0 = (long long)b * S + k * CHUNK;
    copy_rows<CHUNK, CB>(sdt, dt + row0 * D, valid, D, d0, D, vdt);
    copy_rows<CHUNK, NP>(sC, Cm + row0 * N, valid, N, 0, N, vc);
    copy_rows<CHUNK, CB>(sdy, dy + row0 * D, valid, D, d0, D, vdy);
  };
  load(k0, tiles[0]);
  cp_async_commit();
  float an[SPL], acc[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = g * SPL + s;
    const float a = d < D && n < N ? A[(size_t)d * N + n] : 0.f;
    an[s] = a * LOG2E;
    acc[s] = 0.f;
  }
  float cs = 0.f;
  for (int k = k0; k < k1; ++k) {
    const int q = k - k0;
    cp_async_wait<0>();
    __syncthreads();   // chunk k landed; every thread is done with k - 1
    if (k + 1 < k1) {
      load(k + 1, tiles[(q + 1) & 1]);
      cp_async_commit();
    }
    const float* sdt = reinterpret_cast<const float*>(tiles[q & 1]);
    const float* sC = sdt + CHUNK * CB;
    const T* sdy = reinterpret_cast<const T*>(sC + CHUNK * NP);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      cs += sdt[j * CB + c];
      const float dyv = to_f32(sdy[j * CB + c]);
      float cv[SPL];
      load4(cv, sC + j * NP + g * SPL);
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        acc[s] = fmaf(ex2(cs * an[s]), dyv * cv[s], acc[s]);
      }
    }
  }
  if (d < D) {
    const size_t row = ((size_t)b * pieces + piece) * D + d;
    store4(carry + row * NP + g * SPL, acc);
    if (g == 0) seg_dt[row] = cs;
  }
}

template <int NP, typename T, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mamba_scan_bwd(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ dh_last,
               const float* __restrict__ h_chunks,
               const float* __restrict__ carry,
               const float* __restrict__ seg_dt, float* __restrict__ d_dt,
               T* __restrict__ dx, float* __restrict__ ws_bc,
               float* __restrict__ ws_a, int Bt, int S, int D, int N,
               int seg_chunks, int segments, int piece_chunks, int pieces) {
  using L = Layout<NP, T>;
  constexpr int G = L::G, CB = L::CB;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const part_lo = reinterpret_cast<float*>(smem + 2 * L::STAGE);
  float* const part_hi = part_lo + L::PART;
  float* const stash = part_hi + L::PART + threadIdx.x * SPL;

  const int nblk = (D + CB - 1) / CB;
  const int blk = blockIdx.x % nblk;
  const int seg = (int)(blockIdx.x / nblk % segments);
  const int b = (int)(blockIdx.x / nblk / segments);
  const int d0 = blk * CB;
  const int lane = threadIdx.x % 32;
  const int c = threadIdx.x / G, g = threadIdx.x % G;
  const int d = d0 + c;
  const bool active = d < D;
  const int nch = (S + CHUNK - 1) / CHUNK;
  const int k_first = seg * seg_chunks;
  const int k_last = min(k_first + seg_chunks, nch) - 1;
  // where this lane's reduced dB and dC land in its warp's row
  const int first = first_value<G>(lane);
  const int wpos = threadIdx.x / 32 * 2 * NP + first / SPL * NP + g * SPL +
                   first % SPL;
  // the block's rows of the workspace and of d dt and dx
  float* const wsb = ws_bc + ((size_t)blk * Bt + b) * S * 2 * NP;
  float* const ddt = d_dt + (size_t)b * S * D + d0;
  T* const ddx = dx + (size_t)b * S * D + d0;
  const bool vdt = rows16(dt, D), vb = rows16(Bm, N), vc = rows16(Cm, N),
             vh = rows16(h_chunks, NP), vx = rows16(x, D), vdy = rows16(dy, D);

  // chunk k's inputs into a stage
  auto load_chunk = [&](int k, unsigned char* st) {
    float* sdt = reinterpret_cast<float*>(st);
    float* sB = sdt + CHUNK * CB;
    float* sC = sB + CHUNK * NP;
    float* sh = sC + CHUNK * NP;
    T* sx = reinterpret_cast<T*>(sh + CB * NP);
    T* sdy = sx + CHUNK * CB;
    const int valid = min(CHUNK, S - k * CHUNK);
    const long long row0 = (long long)b * S + k * CHUNK;
    copy_rows<CHUNK, CB>(sdt, dt + row0 * D, valid, D, d0, D, vdt);
    copy_rows<CHUNK, NP>(sB, Bm + row0 * N, valid, N, 0, N, vb);
    copy_rows<CHUNK, NP>(sC, Cm + row0 * N, valid, N, 0, N, vc);
    copy_rows<CB, NP>(sh, h_chunks + (((long long)b * nch + k) * D + d0) * NP,
                      min(CB, D - d0), NP, 0, NP, vh);
    copy_rows<CHUNK, CB>(sx, x + row0 * D, valid, D, d0, D, vx);
    copy_rows<CHUNK, CB>(sdy, dy + row0 * D, valid, D, d0, D, vdy);
  };
  load_chunk(k_last, smem);
  cp_async_commit();

  float an[SPL], r[SPL], dA[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = g * SPL + s;
    const bool ok = active && n < N;
    an[s] = ok ? A[(size_t)d * N + n] : 0.f;
    r[s] = ok && dh_last != nullptr ? dh_last[((size_t)b * D + d) * N + n]
                                    : 0.f;
    dA[s] = 0.f;
  }
  // the carry into this segment's last step: the pieces after it folded
  // in, the last first (their decays exp(A sum dt))
  if (active) {
    const int after = (seg + 1) * (seg_chunks / piece_chunks);
    for (int j = pieces - 1; j >= after; --j) {
      const size_t row = ((size_t)b * pieces + j) * D + d;
      const float sd = seg_dt[row];
      float r0[SPL];
      load4(r0, carry + row * NP + g * SPL);
#pragma unroll
      for (int s = 0; s < SPL; ++s) r[s] = fmaf(expf(sd * an[s]), r[s], r0[s]);
    }
  }

  for (int k = k_last; k >= k_first; --k) {
    const int q = k_last - k;
    const unsigned char* st = smem + (q & 1) * L::STAGE;
    cp_async_wait<0>();
    __syncthreads();   // chunk k landed; every thread is done with k + 1
    if (k > k_first) {
      load_chunk(k - 1, smem + ((q + 1) & 1) * L::STAGE);
      cp_async_commit();
    }
    const float* sdt = reinterpret_cast<const float*>(st);
    const float* sB = sdt + CHUNK * CB;
    const float* sC = sB + CHUNK * NP;
    const float* sh = sC + CHUNK * NP;
    const T* sx = reinterpret_cast<const T*>(sh + CB * NP);
    const T* sdy = sx + CHUNK * CB;
    const float* hsave = sh + c * NP + g * SPL;
    const int t0 = k * CHUNK;

    // steps 0..7: the decays kept (the first STASH in shared memory until
    // g comes back to them), the state run on
    float alo[HALF][SPL], h[SPL];
    load4(h, hsave);
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float dtv = sdt[j * CB + c];
      const float u = dtv * to_f32(sx[j * CB + c]);
      float bv[SPL];
      load4(bv, sB + j * NP + g * SPL);
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        alo[j][s] = expf(dtv * an[s]);
        h[s] = fmaf(alo[j][s], h[s], u * bv[s]);
      }
      if (j < STASH) store4(stash + j * THREADS * SPL, alo[j]);
    }
    // steps 8..15: decays and states kept, hhi[i] = h_{7 + i}
    float ahi[HALF][SPL], hhi[HALF + 1][SPL];
#pragma unroll
    for (int s = 0; s < SPL; ++s) hhi[0][s] = h[s];
#pragma unroll
    for (int j = HALF; j < CHUNK; ++j) {
      const int i = j - HALF;
      const float dtv = sdt[j * CB + c];
      const float u = dtv * to_f32(sx[j * CB + c]);
      float bv[SPL];
      load4(bv, sB + j * NP + g * SPL);
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        ahi[i][s] = expf(dtv * an[s]);
        hhi[i + 1][s] = fmaf(ahi[i][s], hhi[i][s], u * bv[s]);
      }
    }
    // g back through steps 15..8
#pragma unroll
    for (int i = HALF - 1; i >= 0; --i)
      back_step<NP, T>(HALF + i, i, ahi[i], hhi[i], hhi[i + 1], an, r, dA,
                       sdt, sB, sC, sx, sdy, part_hi, wpos, c, g);
    __syncthreads();
    sum_half<NP, T>(part_hi, t0 + HALF, S, D, d0, sdt, sx, HALF, wsb,
                    ddt, ddx);
    // steps 0..7 again from the saved state and the kept decays, hlo[j] =
    // h_{j - 1}
    float hlo[HALF + 1][SPL];
    load4(hlo[0], hsave);
#pragma unroll
    for (int j = 0; j < STASH; ++j) load4(alo[j], stash + j * THREADS * SPL);
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float dtv = sdt[j * CB + c];
      const float u = dtv * to_f32(sx[j * CB + c]);
      float bv[SPL];
      load4(bv, sB + j * NP + g * SPL);
#pragma unroll
      for (int s = 0; s < SPL; ++s)
        hlo[j + 1][s] = fmaf(alo[j][s], hlo[j][s], u * bv[s]);
    }
    // g back through steps 7..0
#pragma unroll
    for (int j = HALF - 1; j >= 0; --j)
      back_step<NP, T>(j, j, alo[j], hlo[j], hlo[j + 1], an, r, dA, sdt, sB,
                       sC, sx, sdy, part_lo, wpos, c, g);
    __syncthreads();
    sum_half<NP, T>(part_lo, t0, S, D, d0, sdt, sx, 0, wsb, ddt, ddx);
  }
  if (active)
    store4(ws_a + (((size_t)b * segments + seg) * D + d) * NP + g * SPL, dA);
}

// dB and dC: the channel blocks' partials, a block of SUM_OUT outputs
// each summed in SUM_SLICES strided slices, then the slices in order; dA:
// the (batch row, segment) partials, a thread an output, in order. A
// fixed order, so the same bits on every call.
__global__ void __launch_bounds__(SUM_THREADS)
mamba_scan_bwd_sum(const float* __restrict__ ws_bc,
                   const float* __restrict__ ws_a, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ dA, int Bt,
                   int S, int D, int N, int NP, int nblk, int a_parts) {
  __shared__ float slice[SUM_SLICES][SUM_OUT];
  const long long n_bc = (long long)Bt * S * 2 * N;
  const long long bc_tasks = (n_bc + SUM_OUT - 1) / SUM_OUT;
  if ((long long)blockIdx.x >= bc_tasks) {   // dA
    const long long i =
        ((long long)blockIdx.x - bc_tasks) * SUM_THREADS + threadIdx.x;
    if (i < (long long)D * N) {   // (d, n)
      const float* src = ws_a + (i / N) * NP + i % N;
      const long long pitch = (long long)D * NP;
      float sum = src[0];
      for (int p = 1; p < a_parts; ++p) sum += src[p * pitch];
      dA[i] = sum;
    }
    return;
  }
  const int o = threadIdx.x % SUM_OUT, sl = threadIdx.x / SUM_OUT;
  const long long i = (long long)blockIdx.x * SUM_OUT + o;  // (row, which, n)
  float sum = 0.f;
  if (i < n_bc && sl < nblk) {
    const long long row = i / (2 * N);
    const int e = (int)(i % (2 * N)), which = e / N, n = e % N;
    const float* src = ws_bc + (row * 2 + which) * NP + n;
    const long long pitch = (long long)Bt * S * 2 * NP;
    sum = src[sl * pitch];
    for (int p = sl + SUM_SLICES; p < nblk; p += SUM_SLICES)
      sum += src[p * pitch];
  }
  slice[sl][o] = sum;
  __syncthreads();
  if (sl == 0 && i < n_bc) {
    float total = slice[0][o];
#pragma unroll
    for (int k = 1; k < SUM_SLICES; ++k)
      if (k < nblk) total += slice[k][o];
    const long long row = i / (2 * N);
    const int e = (int)(i % (2 * N));
    (e < N ? dB : dC)[row * N + e % N] = total;
  }
}

template <typename F>
cudaError_t set_smem(F kern) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The instance for (NP, T) and the plan's blocks an SM, after checking
// the plan against it.
template <int NP, typename T>
cudaError_t launch(const void* dt, const void* A, const void* B, const void* C,
                   const void* x, const void* dy, const void* dh_last,
                   const void* h_chunks, void* d_dt, void* dA, void* dB,
                   void* dC, void* dx, void* ws, int Bt, int S, int D, int N,
                   int channels, int chunk, int sum_steps, int threads,
                   int blocks, int seg_chunks, int segments, int piece_chunks,
                   int smem, long long grid, long long pre_grid,
                   long long sum_grid, cudaStream_t s) {
  using L = Layout<NP, T>;
  const long long nblk = (D + L::CB - 1) / L::CB;
  const long long nch = (S + CHUNK - 1) / CHUNK;
  const int pieces =
      piece_chunks > 0 ? (int)((nch + piece_chunks - 1) / piece_chunks) : 0;
  const int first_piece = piece_chunks > 0 ? seg_chunks / piece_chunks : 0;
  const long long bc_tasks =
      ((long long)Bt * S * 2 * N + SUM_OUT - 1) / SUM_OUT;
  const long long a_tasks = ((long long)D * N + SUM_THREADS - 1) / SUM_THREADS;
  if (channels != L::CB || chunk != CHUNK || sum_steps != HALF ||
      threads != THREADS || blocks != L::BLOCKS || seg_chunks < 1 ||
      segments < 1 || segments != (nch + seg_chunks - 1) / seg_chunks ||
      piece_chunks < 1 || seg_chunks % piece_chunks ||
      smem != L::BYTES || smem > SMEM_BLOCK ||
      grid != (long long)Bt * nblk * segments ||
      pre_grid != (long long)Bt * nblk * (pieces - first_piece) ||
      sum_grid != bc_tasks + a_tasks || grid > 0x7fffffffLL ||
      sum_grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // the workspace: dB and dC partials (blocks, Bt, S, 2, NP), dA partials
  // (Bt, segments, D, NP), the pre-pass's carries (Bt, pieces, D, NP) and
  // sums of dt (Bt, pieces, D)
  float* ws_bc = static_cast<float*>(ws);
  float* ws_a = ws_bc + nblk * Bt * S * 2 * NP;
  float* carry = ws_a + (size_t)Bt * segments * D * NP;
  float* seg_dt = carry + (size_t)Bt * pieces * D * NP;
  auto kern = mamba_scan_bwd<NP, T, L::BLOCKS>;
  // once per instance, outside any CUDA-graph capture of later calls
  static cudaError_t attr = set_smem(kern);
  if (attr != cudaSuccess) return attr;
  if (pre_grid > 0) {
    mamba_scan_bwd_carry<NP, T><<<(unsigned)pre_grid, THREADS, 0, s>>>(
        static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<const float*>(C), static_cast<const T*>(dy), carry, seg_dt,
        S, D, N, piece_chunks, pieces, first_piece);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)grid, THREADS, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(h_chunks),
      carry, seg_dt, static_cast<float*>(d_dt), static_cast<T*>(dx), ws_bc,
      ws_a, Bt, S, D, N, seg_chunks, segments, piece_chunks, pieces);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mamba_scan_bwd_sum<<<(unsigned)sum_grid, SUM_THREADS, 0, s>>>(
      ws_bc, ws_a, static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), Bt, S, D, N, NP, (int)nblk, Bt * segments);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(int NP, int SPL_, const void* dt, const void* A,
                       const void* B, const void* C, const void* x,
                       const void* dy, const void* dh_last,
                       const void* h_chunks, void* d_dt, void* dA, void* dB,
                       void* dC, void* dx, void* ws, int Bt, int S, int D,
                       int N, int channels, int chunk, int sum_steps,
                       int threads, int blocks, int seg_chunks, int segments,
                       int piece_chunks, int smem, long long grid,
                       long long pre_grid, long long sum_grid,
                       cudaStream_t s) {
#define REPRO_SCAN_BWD(np, spl)                                              \
  if (NP == np && SPL_ == spl)                                               \
    return launch<np, T>(dt, A, B, C, x, dy, dh_last, h_chunks, d_dt, dA,    \
                         dB, dC, dx, ws, Bt, S, D, N, channels, chunk,       \
                         sum_steps, threads, blocks, seg_chunks, segments,   \
                         piece_chunks, smem, grid, pre_grid, sum_grid, s);
  REPRO_SCAN_BWD(4, 4)
  REPRO_SCAN_BWD(8, 4)
  REPRO_SCAN_BWD(16, 4)
  REPRO_SCAN_BWD(32, 4)
  REPRO_SCAN_BWD(64, 4)
#undef REPRO_SCAN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launches (0 on success): the pre-pass
// (when segments > 1), the scan, the sums. The caller has checked shapes,
// dtypes, contiguity, 1 <= N <= 64 and Bt, S, D > 0, and passes the plan
// of kernels/mamba_scan.py (`plan_bwd`): the padded state width NP, states
// a lane SPL, channels a block, the chunk length, the steps summed at
// once, threads a block, the blocks an SM its registers are bounded for
// (2 to 4), chunks a segment, segments, chunks a piece of the pre-pass
// (dividing chunks a segment), the dynamic shared memory in bytes and the
// three grids; a plan that does not match the instance returns
// cudaErrorInvalidValue unlaunched. dh_last may be null; h_chunks is the
// forward's (Bt, ceil(S / 16), D, np) output; ws holds the plan's
// `ws_floats` floats.
extern "C" int repro_mamba_scan_bwd(
    const void* dt, const void* A, const void* B, const void* C, const void* x,
    const void* dy, const void* dh_last, const void* h_chunks, void* d_dt,
    void* dA, void* dB, void* dC, void* dx, void* ws, int Bt, int S, int D,
    int N, int x_is_bf16, int np, int spl, int channels, int chunk,
    int sum_steps, int threads, int blocks, int seg_chunks, int segments,
    int piece_chunks, int smem, long long grid, long long pre_grid,
    long long sum_grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_for<__nv_bfloat16>(
        np, spl, dt, A, B, C, x, dy, dh_last, h_chunks, d_dt, dA, dB, dC, dx,
        ws, Bt, S, D, N, channels, chunk, sum_steps, threads, blocks,
        seg_chunks, segments, piece_chunks, smem, grid, pre_grid, sum_grid,
        s);
  return launch_for<float>(np, spl, dt, A, B, C, x, dy, dh_last, h_chunks,
                           d_dt, dA, dB, dC, dx, ws, Bt, S, D, N, channels,
                           chunk, sum_steps, threads, blocks, seg_chunks,
                           segments, piece_chunks, smem, grid, pre_grid,
                           sum_grid, s);
}
