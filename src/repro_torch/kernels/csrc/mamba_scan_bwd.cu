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
// with the memory and the MUFUs close behind. On the card it is bound by
// neither: each step's work waits on the step before it (the carry, the
// shuffles of its sums), and one block of 8 consumer warps an SM hides
// little of that latency (PERF.md).
//
// Design:
//   * The forward's layout: G = NP / 4 lanes a channel, 4 states each, a
//     block of CB = 256 / G channels, Bt folded into the grid's x. The
//     g recurrence is independent per (b, d, n), as h's is.
//   * Saved states, not stored history: the forward saves the state at
//     the start of every CHUNK = 16 steps (h_chunks, 32 MB at the
//     microbatch shape against 537 MB for every h_t). Walking the chunks
//     in reverse, a lane recomputes its chunk's 16 states and their
//     16 a_t into registers (128 of them; one exponential a state-step
//     in all), then runs g back through the chunk. 16 is what the
//     registers hold: 8 would double the saved states and the per-chunk
//     overhead, 32 would not fit the 168 registers a thread of a
//     288-thread block gets (9 warps, 3 on one scheduler's quarter of
//     the register file); one block an SM is all the microbatch shape
//     fills anyway (128 blocks).
//   * a_t is libdevice's expf(dt A), as in the forward's training
//     instance, so the recomputed states are the forward's bits; the
//     serving instance's ex2.approx would put the grads 3 to 4x farther
//     from an fp64 truth than the plain version's (mamba_scan.cu).
//   * The inputs of a chunk arrive as in the forward: a producer warp
//     keeps a ring of tiles of dt, x, dy, B and C full with cp.async, in
//     reverse chunk order, on full and empty mbarriers.
//   * d dt and dx sum over the lanes of a channel: G partials a lane, one
//     a step, reduce-scattered over the lanes every G steps, so lane g
//     stores step g (as the forward stores y).
//   * No two blocks add into one element. dB_t and dC_t sum over the
//     channels of every block: a warp sums its channels by shuffles
//     (reduce_channels), the warps' sums meet in shared memory (a double
//     buffer, so one barrier a chunk), and each block writes its partial
//     sums to a workspace, (blocks, Bt, S, 2, N). dA sums over Bt: each block writes its own
//     (Bt, D, N) rows. A second kernel, `mamba_scan_bwd_sum`, adds the
//     partials in a fixed order, so two calls give the same bits.
//   * Padding is arithmetic, as in the forward: states past N have A =
//     B = C = 0 and g = 0; channels past D and steps past S read zeros,
//     so a = 1 carries g through them unchanged; only stores are masked.
//   * The launch is planned in Python (`mamba_scan.plan_bwd`), and this
//     side refuses a plan that does not match the instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan.cuh"
#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace scan;

constexpr int CONSUMERS = 256;            // consumer threads a block
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int WARPS = CONSUMERS / 32;
constexpr int SMEM_BLOCK = 232448;        // what one block may use (227 KB)
constexpr int SUM_THREADS = 256;          // the second kernel's blocks

// bytes of one ring stage: dt, x and dy for CB channels, B and C for NP
// states, CHUNK steps
template <int NP, int CB, typename T>
__host__ __device__ constexpr int bwd_stage_bytes() {
  return CHUNK * (CB * (4 + 2 * (int)sizeof(T)) + 2 * NP * 4);
}
// the warps' sums of dB and dC, two chunks of [CHUNK][WARPS][2][NP]
template <int NP>
__host__ __device__ constexpr int red_floats() {
  return 2 * CHUNK * WARPS * 2 * NP;
}

template <int NP, int SPL, typename T>
__global__ void __launch_bounds__(THREADS, 1)
mamba_scan_bwd(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ dh_last,
               const float* __restrict__ h_chunks, float* __restrict__ d_dt,
               T* __restrict__ dx, float* __restrict__ ws_bc,
               float* __restrict__ ws_a, int Bt, int S, int D, int N,
               int stages) {
  constexpr int G = NP / SPL;        // lanes a channel
  constexpr int CB = CONSUMERS / G;  // channels a block
  constexpr int V = 2 * SPL;         // a lane's dB and dC partials a step
  constexpr int K = V * G / 32 > 1 ? V * G / 32 : 1;  // sums a lane keeps
  static_assert(SPL == 4 && NP % SPL == 0 && 32 % G == 0 && CHUNK % G == 0,
                "plan");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sbytes = bwd_stage_bytes<NP, CB, T>();
  float* red = reinterpret_cast<float*>(smem + stages * sbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + red_floats<NP>());
  uint64_t* empty = full + stages;

  const int nblk = (D + CB - 1) / CB;
  const int blk = blockIdx.x % nblk;
  const int b = blockIdx.x / nblk;
  const int d0 = blk * CB;
  const int lane = threadIdx.x % 32;
  const int nch = (S + CHUNK - 1) / CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 32);                // the producer's lanes
      sm90::mbar_init(&empty[s], CONSUMERS / 32);   // one a consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp, chunks in reverse
    const bool vec_dt = reinterpret_cast<uintptr_t>(dt) % 16 == 0 && D % 4 == 0;
    const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       D % (16 / (int)sizeof(T)) == 0;
    const bool vec_dy = reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                        D % (16 / (int)sizeof(T)) == 0;
    const bool vec_b = reinterpret_cast<uintptr_t>(Bm) % 16 == 0 && N % 4 == 0;
    const bool vec_c = reinterpret_cast<uintptr_t>(Cm) % 16 == 0 && N % 4 == 0;
    for (int q = 0; q < nch; ++q) {
      const int slot = q % stages;
      if (q >= stages) sm90::mbar_wait(&empty[slot], (q / stages - 1) & 1);
      unsigned char* st = smem + slot * sbytes;
      float* sdt = reinterpret_cast<float*>(st);
      T* sx = reinterpret_cast<T*>(sdt + CHUNK * CB);
      T* sdy = sx + CHUNK * CB;
      float* sB = reinterpret_cast<float*>(sdy + CHUNK * CB);
      float* sC = sB + CHUNK * NP;
      const int t0 = (nch - 1 - q) * CHUNK;
      const int valid = min(CHUNK, S - t0);
      const long long row0 = (long long)b * S + t0;
      copy_tile<CB>(sdt, dt, row0, CHUNK, valid, D, d0, D, vec_dt, lane);
      copy_tile<CB>(sx, x, row0, CHUNK, valid, D, d0, D, vec_x, lane);
      copy_tile<CB>(sdy, dy, row0, CHUNK, valid, D, d0, D, vec_dy, lane);
      copy_tile<NP>(sB, Bm, row0, CHUNK, valid, N, 0, N, vec_b, lane);
      copy_tile<NP>(sC, Cm, row0, CHUNK, valid, N, 0, N, vec_c, lane);
      cp_async_mbar_arrive(&full[slot]);
      sm90::mbar_arrive(&full[slot]);
    }
    cp_async_commit();  // the last copies land before the warp exits
    cp_async_wait<0>();
    return;
  }

  // consumers: lane g of channel c holds states g*SPL .. g*SPL + SPL-1
  const int c = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int warp = threadIdx.x / 32;
  const int d = d0 + c;
  const bool active = d < D;
  float an[SPL], r[SPL], dA[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = g * SPL + s;
    const bool ok = active && n < N;
    an[s] = ok ? A[(size_t)d * N + n] : 0.f;
    r[s] = ok && dh_last != nullptr ? dh_last[((size_t)b * D + d) * N + n] : 0.f;
    dA[s] = 0.f;
  }
  // this lane's states at the chunk starts, (Bt, nch, D, NP)
  const float* hcp = h_chunks + ((size_t)b * nch * D + (active ? d : 0)) * NP + g * SPL;
  const size_t chunk_pitch = (size_t)D * NP;
  float4 h_next = active ? *reinterpret_cast<const float4*>(hcp + (nch - 1) * chunk_pitch)
                         : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int q = 0; q < nch; ++q) {
    const int k = nch - 1 - q;   // the chunk, last first
    const int slot = q % stages;
    const float h0[SPL] = {h_next.x, h_next.y, h_next.z, h_next.w};
    if (k > 0 && active)
      h_next = *reinterpret_cast<const float4*>(hcp + (k - 1) * chunk_pitch);
    sm90::mbar_wait(&full[slot], (q / stages) & 1);
    const unsigned char* st = smem + slot * sbytes;
    const float* sdt = reinterpret_cast<const float*>(st);
    const T* sx = reinterpret_cast<const T*>(sdt + CHUNK * CB);
    const T* sdy = sx + CHUNK * CB;
    const float* sB = reinterpret_cast<const float*>(sdy + CHUNK * CB) + g * SPL;
    const float* sC = sB + CHUNK * NP;

    // the chunk's states and decays, as the forward's training instance
    // computed them
    float hs[CHUNK][SPL], as[CHUNK][SPL];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const float dtv = sdt[j * CB + c];
      const float u = dtv * to_f32(sx[j * CB + c]);
      const float4 b4 = *reinterpret_cast<const float4*>(sB + j * NP);
      const float bv[SPL] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        as[j][s] = expf(dtv * an[s]);
        hs[j][s] = fmaf(as[j][s], j ? hs[j > 0 ? j - 1 : 0][s] : h0[s],
                         u * bv[s]);
      }
    }

    // g back through the chunk, G steps a group
    float* rb = red + (q & 1) * (CHUNK * WARPS * 2 * NP);
#pragma unroll
    for (int grp = CHUNK / G - 1; grp >= 0; --grp) {
      float pdt[G], pdu[G];
#pragma unroll
      for (int jj = G - 1; jj >= 0; --jj) {
        const int j = grp * G + jj;
        const float dtv = sdt[j * CB + c];
        const float u = dtv * to_f32(sx[j * CB + c]);
        const float dyv = to_f32(sdy[j * CB + c]);
        const float4 b4 = *reinterpret_cast<const float4*>(sB + j * NP);
        const float4 c4 = *reinterpret_cast<const float4*>(sC + j * NP);
        const float bv[SPL] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[SPL] = {c4.x, c4.y, c4.z, c4.w};
        float v[V];
        float du = 0.f, sa = 0.f;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          const float gs = fmaf(dyv, cv[s], r[s]);
          const float t1 =
              gs * (as[j][s] * (j ? hs[j > 0 ? j - 1 : 0][s] : h0[s]));
          v[s] = gs * u;             // dB
          v[SPL + s] = dyv * hs[j][s];   // dC
          du = fmaf(gs, bv[s], du);
          sa = fmaf(t1, an[s], sa);
          dA[s] = fmaf(t1, dtv, dA[s]);
          r[s] = as[j][s] * gs;
        }
        pdt[jj] = sa;
        pdu[jj] = du;
        const int first = reduce_channels<G, V>(v, lane);
        if (first >= 0) {
          float* o = rb + (j * WARPS + warp) * 2 * NP;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const int e = first + i;   // dB (e < SPL) or dC of state g*SPL + e % SPL
            o[(e / SPL) * NP + g * SPL + e % SPL] = v[i];
          }
        }
      }
      const float sa = reduce_scatter<G>(pdt, g);
      const float du = reduce_scatter<G>(pdu, g);
      const int j = grp * G + g;   // lane g's step
      const int t = k * CHUNK + j;
      if (active && t < S) {
        const size_t o = ((size_t)b * S + t) * D + d;
        d_dt[o] = fmaf(to_f32(sx[j * CB + c]), du, sa);
        store(dx + o, sdt[j * CB + c] * du);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);

    // the block's dB and dC of the chunk: the warps' sums, in warp order
    sm90::bar_sync(1, CONSUMERS);
    for (int o = threadIdx.x; o < CHUNK * 2 * NP; o += CONSUMERS) {
      const int j = o / (2 * NP), e = o % (2 * NP);
      const int which = e / NP, n = e % NP;
      const int t = k * CHUNK + j;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += rb[(j * WARPS + w) * 2 * NP + e];
      if (t < S && n < N)
        ws_bc[((((size_t)blk * Bt + b) * S + t) * 2 + which) * N + n] = sum;
    }
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = g * SPL + s;
      if (n < N) ws_a[((size_t)b * D + d) * N + n] = dA[s];
    }
  }
}

// dB and dC: the blocks' partials summed in block order; dA: the batch
// rows' partials summed in row order. One thread an output element.
__global__ void __launch_bounds__(SUM_THREADS)
mamba_scan_bwd_sum(const float* __restrict__ ws_bc,
                   const float* __restrict__ ws_a, float* __restrict__ dB,
                   float* __restrict__ dC, float* __restrict__ dA,
                   long long n_bc, long long n_a, int nblk, int Bt, int N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_bc + n_a; i += stride) {
    if (i < n_bc) {   // i = ((b * S + t) * 2 + which) * N + n
      float sum = 0.f;
      for (int k = 0; k < nblk; ++k) sum += ws_bc[k * n_bc + i];
      const long long row = i / (2 * N);
      const int e = (int)(i % (2 * N));
      (e < N ? dB : dC)[row * N + e % N] = sum;
    } else {          // j = d * N + n
      const long long j = i - n_bc;
      float sum = 0.f;
      for (int bb = 0; bb < Bt; ++bb) sum += ws_a[bb * n_a + j];
      dA[j] = sum;
    }
  }
}

// The instance for (NP, SPL, T), after checking the plan against it.
template <int NP, int SPL, typename T>
cudaError_t launch(const void* dt, const void* A, const void* B, const void* C,
                   const void* x, const void* dy, const void* dh_last,
                   const void* h_chunks, void* d_dt, void* dA, void* dB,
                   void* dC, void* dx, void* ws_bc, void* ws_a, int Bt, int S,
                   int D, int N, int channels, int chunk, int stages, int smem,
                   long long grid, int sum_grid, cudaStream_t s) {
  constexpr int G = NP / SPL;
  constexpr int CB = CONSUMERS / G;
  const long long nblk = (D + CB - 1) / CB;
  if (channels != CB || chunk != CHUNK || stages < 2 ||
      smem != stages * (bwd_stage_bytes<NP, CB, T>() + 16) +
                  red_floats<NP>() * 4 ||
      smem > SMEM_BLOCK || grid != (long long)Bt * nblk ||
      grid > 0x7fffffffLL || sum_grid < 1)
    return cudaErrorInvalidValue;
  auto kern = mamba_scan_bwd<NP, SPL, T>;
  // once per instance, outside any CUDA-graph capture of later calls
  static cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
  if (attr != cudaSuccess) return attr;
  kern<<<(unsigned)grid, THREADS, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(h_chunks),
      static_cast<float*>(d_dt), static_cast<T*>(dx),
      static_cast<float*>(ws_bc), static_cast<float*>(ws_a), Bt, S, D, N,
      stages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mamba_scan_bwd_sum<<<sum_grid, SUM_THREADS, 0, s>>>(
      static_cast<const float*>(ws_bc), static_cast<const float*>(ws_a),
      static_cast<float*>(dB), static_cast<float*>(dC), static_cast<float*>(dA),
      (long long)Bt * S * 2 * N, (long long)D * N, (int)nblk, Bt, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(int NP, int SPL, const void* dt, const void* A,
                       const void* B, const void* C, const void* x,
                       const void* dy, const void* dh_last,
                       const void* h_chunks, void* d_dt, void* dA, void* dB,
                       void* dC, void* dx, void* ws_bc, void* ws_a, int Bt,
                       int S, int D, int N, int channels, int chunk,
                       int stages, int smem, long long grid, int sum_grid,
                       cudaStream_t s) {
#define REPRO_SCAN_BWD(np, spl)                                              \
  if (NP == np && SPL == spl)                                                \
    return launch<np, spl, T>(dt, A, B, C, x, dy, dh_last, h_chunks, d_dt,   \
                              dA, dB, dC, dx, ws_bc, ws_a, Bt, S, D, N,      \
                              channels, chunk, stages, smem, grid, sum_grid, \
                              s);
  REPRO_SCAN_BWD(4, 4)
  REPRO_SCAN_BWD(8, 4)
  REPRO_SCAN_BWD(16, 4)
  REPRO_SCAN_BWD(32, 4)
  REPRO_SCAN_BWD(64, 4)
#undef REPRO_SCAN_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the two launches (0 on success). The caller
// has checked shapes, dtypes, contiguity, 1 <= N <= 64 and Bt, S, D > 0,
// and passes the plan of kernels/mamba_scan.py (`plan_bwd`): the padded
// state width NP, states a lane SPL, channels a block, the chunk length,
// the ring's stages, the dynamic shared memory in bytes, the grid and the
// second kernel's grid; a plan that does not match the instance returns
// cudaErrorInvalidValue unlaunched. dh_last may be null; h_chunks is the
// forward's (Bt, ceil(S / 16), D, np) output; ws_bc holds (blocks, Bt, S,
// 2, N) floats and ws_a (Bt, D, N).
extern "C" int repro_mamba_scan_bwd(
    const void* dt, const void* A, const void* B, const void* C, const void* x,
    const void* dy, const void* dh_last, const void* h_chunks, void* d_dt,
    void* dA, void* dB, void* dC, void* dx, void* ws_bc, void* ws_a, int Bt,
    int S, int D, int N, int x_is_bf16, int np, int spl, int channels,
    int chunk, int stages, int smem, long long grid, int sum_grid,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_for<__nv_bfloat16>(np, spl, dt, A, B, C, x, dy, dh_last,
                                     h_chunks, d_dt, dA, dB, dC, dx, ws_bc,
                                     ws_a, Bt, S, D, N, channels, chunk,
                                     stages, smem, grid, sum_grid, s);
  return launch_for<float>(np, spl, dt, A, B, C, x, dy, dh_last, h_chunks,
                           d_dt, dA, dB, dC, dx, ws_bc, ws_a, Bt, S, D, N,
                           channels, chunk, stages, smem, grid, sum_grid, s);
}
