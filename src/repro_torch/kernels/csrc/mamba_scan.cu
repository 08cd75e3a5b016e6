// Selective scan (Mamba-1) with an fp32 state, from h_0 = 0:
//   h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t * x_t) B_t ;   y_t = h_t . C_t
// dt, x: (Bt,S,D); A: (D,N); B, C: (Bt,S,N); dt, A, B, C fp32; x and y
// bf16 or fp32 (y in x's dtype). Also writes h_last (Bt,D,N) fp32, the
// state after step S, which prefill hands to decode, and, given a
// non-null h_chunks (training), the state before every 16th step for the
// backward kernel (mamba_scan_bwd.cu).
//
// Replaces the TPU kernel `_scan_kernel` / `mamba_scan_pallas`
// (src/repro/kernels/mamba_scan.py:27,51), which walks a sequential grid
// axis over 128-step chunks and carries h in VMEM scratch. Blocks of a
// CUDA grid run in no order, so the time loop moves inside the block.
//
// What bounds it on an H100: per (b, t, d) it reads dt (4 B) and x and
// writes y (2 B each in bf16), and per (b, t, d, n) it evaluates one
// exponential. At the falcon-mamba prefill shape (4, 1024, 8192, 16) a
// layer is 269 MB (0.080 ms at 3.35 TB/s) against 537 M exponentials:
// 0.128 ms at 16 a clock per SM on the special-function units (MUFU) at
// 1.98 GHz. So the exponentials bound it on paper. Each state-step also
// needs four FP32 instructions (dt * a, u * B, the h FMA, the y FMA); a
// scheduler issues one instruction a clock and its MUFU takes a warp's
// exponential in 8, so the kernel reaches the bound only if everything
// else a step costs stays under about 3 instructions a state.
//
// How the design gets there:
//   * The state is split over lanes. G = NP / SPL neighbouring lanes own
//     one channel, each SPL (4) of its NP states and the same slice of A
//     in registers for the whole sequence: 4x the threads of one thread a
//     channel at N = 16 (131 072 at the model's shape, about 31 warps an
//     SM), so the MUFUs never wait on a dependent chain.
//   * A's slice is scaled by log2(e) once, when it is loaded; each state
//     then takes one `ex2.approx.ftz.f32` (a single MUFU.EX2, relative
//     error about 2^-22, far inside the checks' 2e-3) of dt * a'. The
//     training instance (TRAINING, chosen by a non-null h_chunks) writes
//     the chunk states and takes libdevice's expf(dt * a) instead, as the
//     backward kernel's recompute does: ex2.approx's error, compounded
//     over the 1 / (dt |A|) steps a state remembers, put the grads 3 to
//     4x farther from an fp64 truth than the plain version's on
//     falcon-mamba-7b's inputs, and expf brings them level. Serving's
//     instance keeps ex2.approx and stores nothing more, so its y and
//     h_last keep their bits (tools/scan_digest.py compares two trees).
//   * What one step shares is paid once per lane, not per state: dt, x,
//     u = dt * x, and B's and C's slices as 16-byte shared-memory loads.
//     y's G partial sums are reduce-scattered over the lanes every G
//     steps (G - 1 shuffles and adds, in a fixed order, so two calls give
//     the same bits), after which lane g holds and stores y of step g.
//   * Every per-step input is staged ahead of use. A producer warp keeps
//     a ring of 2 or 3 time tiles of dt, x, B and C full with 16-byte
//     cp.async (zero-filled past S and D; element by element where the
//     rows are not 16-byte aligned); full and empty mbarriers per stage
//     replace the block-wide barriers, so consumer warps never wait on
//     one another or on device memory.
//   * Padding is arithmetic, not branches: states past N have A = B = C
//     = 0, channels past D and steps past S read dt = x = B = C = 0, so
//     exp2(0) = 1 keeps h as it is; only the stores are masked.
//   * The launch is planned in Python (`mamba_scan.plan`: NP, SPL,
//     channels a block, time tile, stages, shared memory, grid), and this
//     side refuses a plan that does not match the instance it picks.
//     Batch is folded into the grid's x dimension, so Bt is not capped at
//     65 535.
//
// Why not a two-pass chunked scan: correcting each chunk's y for the
// state carried in needs exp(A * cumsum dt) for every step and state, a
// second exponential per state-step, which doubles the bound (16.4 ms a
// falcon-mamba-7b prefill against 8.2). Splitting N over lanes gives the
// parallelism and keeps one exponential per state-step.
//
// Left: on the card the exponentials do not bind; the instructions
// around them do (the four FP32 instructions of a state-step, then the
// per-step loads, shuffles and stores), and they hold the kernel near
// half its bound (PERF.md). Not tried: the tensor cores for u * B and
// h . C, y staged for coalesced rows rather than stored by a lane per
// step and channel. The Mamba decode recurrence stays plain PyTorch.
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
constexpr int RESIDENT = 4;               // blocks an SM is planned for
constexpr int SMEM_BLOCK = 232448;        // what one block may use (227 KB)
// bytes of one ring stage: dt and x for CB channels, B and C for NP
// states, `tt` time steps
template <int NP, int CB, typename T>
__host__ __device__ constexpr int stage_bytes(int tt) {
  return tt * (CB * (4 + (int)sizeof(T)) + 2 * NP * 4);
}

template <int NP, int SPL, typename T, bool TRAINING>
__global__ void __launch_bounds__(THREADS, RESIDENT)
mamba_scan(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm,
           const T* __restrict__ x, T* __restrict__ y,
           float* __restrict__ h_last, float* __restrict__ h_chunks, int S,
           int D, int N, int TT, int stages) {
  constexpr int G = NP / SPL;       // lanes a channel
  constexpr int CB = CONSUMERS / G;  // channels a block
  constexpr int UNROLL = G >= 8 ? 1 : 8 / G;  // groups of G steps
  static_assert(SPL % 4 == 0 && NP % SPL == 0 && 32 % G == 0 &&
                CHUNK % G == 0, "plan");
  extern __shared__ __align__(16) unsigned char smem[];
  const int sbytes = stage_bytes<NP, CB, T>(TT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * sbytes);
  uint64_t* empty = full + stages;

  const int nblk = (D + CB - 1) / CB;
  const int b = blockIdx.x / nblk;
  const int d0 = (blockIdx.x % nblk) * CB;
  const int lane = threadIdx.x % 32;
  const int ntiles = (S + TT - 1) / TT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 32);                // the producer's lanes
      sm90::mbar_init(&empty[s], CONSUMERS / 32);   // one a consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    const bool vec_dt = reinterpret_cast<uintptr_t>(dt) % 16 == 0 && D % 4 == 0;
    const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       D % (16 / (int)sizeof(T)) == 0;
    const bool vec_b = reinterpret_cast<uintptr_t>(Bm) % 16 == 0 && N % 4 == 0;
    const bool vec_c = reinterpret_cast<uintptr_t>(Cm) % 16 == 0 && N % 4 == 0;
    for (int k = 0; k < ntiles; ++k) {
      const int slot = k % stages;
      if (k >= stages) sm90::mbar_wait(&empty[slot], (k / stages - 1) & 1);
      unsigned char* st = smem + slot * sbytes;
      float* sdt = reinterpret_cast<float*>(st);
      T* sx = reinterpret_cast<T*>(sdt + TT * CB);
      float* sB = reinterpret_cast<float*>(sx + TT * CB);
      float* sC = sB + TT * NP;
      const int t0 = k * TT;
      const int valid = min(TT, S - t0);
      const long long row0 = (long long)b * S + t0;
      copy_tile<CB>(sdt, dt, row0, TT, valid, D, d0, D, vec_dt, lane);
      copy_tile<CB>(sx, x, row0, TT, valid, D, d0, D, vec_x, lane);
      copy_tile<NP>(sB, Bm, row0, TT, valid, N, 0, N, vec_b, lane);
      copy_tile<NP>(sC, Cm, row0, TT, valid, N, 0, N, vec_c, lane);
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
  const int d = d0 + c;
  const bool active = d < D;
  float a[SPL], h[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int n = g * SPL + s;
    const float an = (active && n < N) ? A[(size_t)d * N + n] : 0.f;
    a[s] = TRAINING ? an : an * LOG2E;
    h[s] = 0.f;
  }
  // lane g stores y of steps g, g + G, g + 2G, ...
  T* yp = y + ((size_t)b * S + g) * D + d;
  int left = S - g;  // steps from yp's on
  // training: the state before every CHUNK-th step, (Bt, ceil(S /
  // CHUNK), D, NP), this lane's SPL states as 16-byte stores
  const int nch = (S + CHUNK - 1) / CHUNK;
  float* hcp = TRAINING && active
                   ? h_chunks + ((size_t)b * nch * D + d) * NP + g * SPL
                   : nullptr;

  for (int k = 0; k < ntiles; ++k) {
    const int slot = k % stages;
    sm90::mbar_wait(&full[slot], (k / stages) & 1);
    const unsigned char* st = smem + slot * sbytes;
    const float* sdt = reinterpret_cast<const float*>(st);
    const T* sx = reinterpret_cast<const T*>(sdt + TT * CB);
    const float* sB = reinterpret_cast<const float*>(sx + TT * CB) + g * SPL;
    const float* sC = sB + TT * NP;
#pragma unroll UNROLL
    for (int r0 = 0; r0 < TT; r0 += G) {
      const int t = k * TT + r0;   // CHUNK % G == 0: every chunk starts a group
      if (TRAINING && hcp != nullptr && t % CHUNK == 0 && t < S) {
        float* o = hcp + (size_t)(t / CHUNK) * D * NP;
#pragma unroll
        for (int s = 0; s < SPL; s += 4)
          *reinterpret_cast<float4*>(o + s) =
              make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
      }
      float p[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int r = r0 + j;
        const float dtv = sdt[r * CB + c];
        const float u = dtv * to_f32(sx[r * CB + c]);
        float bv[SPL], cv[SPL];
#pragma unroll
        for (int s = 0; s < SPL; s += 4) {
          const float4 b4 = *reinterpret_cast<const float4*>(sB + r * NP + s);
          const float4 c4 = *reinterpret_cast<const float4*>(sC + r * NP + s);
          bv[s] = b4.x, bv[s + 1] = b4.y, bv[s + 2] = b4.z, bv[s + 3] = b4.w;
          cv[s] = c4.x, cv[s + 1] = c4.y, cv[s + 2] = c4.z, cv[s + 3] = c4.w;
        }
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < SPL; ++s) {
          h[s] = fmaf(TRAINING ? expf(dtv * a[s]) : ex2(dtv * a[s]), h[s],
                      u * bv[s]);
          acc = fmaf(h[s], cv[s], acc);
        }
        p[j] = acc;
      }
      const float yv = reduce_scatter<G>(p, g);
      if (active && left > 0) store(yp, yv);
      yp += (size_t)G * D;
      left -= G;
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[slot]);
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const int n = g * SPL + s;
      if (n < N) h_last[((size_t)b * D + d) * N + n] = h[s];
    }
  }
}

// The instance for (NP, SPL, T), after checking the plan against it.
template <int NP, int SPL, typename T>
cudaError_t launch(const void* dt, const void* A, const void* B,
                   const void* C, const void* x, void* y, void* h_last,
                   void* h_chunks, int Bt, int S, int D, int N, int channels,
                   int TT, int stages, int smem, long long grid,
                   cudaStream_t s) {
  constexpr int G = NP / SPL;
  constexpr int CB = CONSUMERS / G;
  const long long nblk = (D + CB - 1) / CB;
  if (channels != CB || TT <= 0 || TT % G || TT % 8 || stages < 2 ||
      smem != stages * (stage_bytes<NP, CB, T>(TT) + 16) || smem > SMEM_BLOCK ||
      grid != (long long)Bt * nblk || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto kern = h_chunks != nullptr ? mamba_scan<NP, SPL, T, true>
                                  : mamba_scan<NP, SPL, T, false>;
  // once per instance, outside any CUDA-graph capture of later calls: any
  // plan's shared memory, and the SM's whole carveout as shared memory so
  // that RESIDENT blocks fit
  // (cudaErrorNotReady: not set yet)
  static cudaError_t attrs[2] = {cudaErrorNotReady, cudaErrorNotReady};
  cudaError_t& attr = attrs[h_chunks != nullptr];
  if (attr == cudaErrorNotReady) attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  kern<<<(unsigned)grid, THREADS, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(h_chunks), S, D, N,
      TT, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for(int NP, int SPL, const void* dt, const void* A,
                       const void* B, const void* C, const void* x, void* y,
                       void* h_last, void* h_chunks, int Bt, int S, int D,
                       int N, int channels, int TT, int stages, int smem,
                       long long grid, cudaStream_t s) {
#define REPRO_SCAN(np, spl)                                                  \
  if (NP == np && SPL == spl)                                                \
    return launch<np, spl, T>(dt, A, B, C, x, y, h_last, h_chunks, Bt, S, D, \
                              N, channels, TT, stages, smem, grid, s);
  REPRO_SCAN(4, 4)
  REPRO_SCAN(8, 4)
  REPRO_SCAN(16, 4)
  REPRO_SCAN(32, 4)
  REPRO_SCAN(64, 4)
#undef REPRO_SCAN
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success). The caller has
// checked shapes, dtypes, contiguity, 1 <= N <= 64 and Bt, D > 0, and
// passes the plan of kernels/mamba_scan.py (`plan`): the padded state
// width NP, states a lane SPL, channels a block, the time tile, the ring's
// stages, the dynamic shared memory in bytes and the grid; a plan that
// does not match the instance returns cudaErrorInvalidValue unlaunched.
// `h_chunks` is null (serving) or (Bt, ceil(S / 16), D, np) fp32 for the
// states at the chunk starts that the backward kernel reads.
extern "C" int repro_mamba_scan(const void* dt, const void* A, const void* B,
                                const void* C, const void* x, void* y,
                                void* h_last, void* h_chunks, int Bt, int S,
                                int D, int N, int x_is_bf16, int np, int spl,
                                int channels, int time_tile, int stages,
                                int smem, long long grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    return launch_for<__nv_bfloat16>(np, spl, dt, A, B, C, x, y, h_last,
                                     h_chunks, Bt, S, D, N, channels,
                                     time_tile, stages, smem, grid, s);
  return launch_for<float>(np, spl, dt, A, B, C, x, y, h_last, h_chunks, Bt,
                           S, D, N, channels, time_tile, stages, smem, grid,
                           s);
}
