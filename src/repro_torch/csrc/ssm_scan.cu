// Mamba-1 selective scan with an f32 state and a zero initial state:
//   h = exp(dt * A) * h + (dt * u) * B,   y = h . C + D * u,   A = -exp(a_log).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel). Layouts are the reference's: u, dt (B,T,D); B, C (B,T,S);
// a_log (D,S); d_skip (D,); outputs y (B,T,D) f32 and h_final (B,D,S) f32,
// all contiguous.
//
// Bound on an H100 (falcon-mamba-7b prefill: B=4, T=2048, D=8192, S=16):
// device-memory bytes at the card's peak rates. u and dt are read once
// (268 MB in bf16), y is written once (268 MB in f32): 0.16 ms at 3.35 TB/s.
// The arithmetic is ~7 f32 operations per (b, t, d, s), 0.11 ms at 67
// TFLOP/s. But one of them is an exp, and B*T*D*S = 1.07e9 exps go through
// the special-function units at 16 per clock per SM (~0.26 ms at 1.98 GHz):
// that is the limit of this design, which evaluates every exp with ex2.
//
// Design:
//   * The Pallas kernel walks time as the last, sequential grid axis and
//     carries the (bd, S) state in VMEM scratch between grid steps. CUDA
//     blocks run in no order, so each block owns 64 channels of one batch
//     row for the whole sequence and loops over time inside itself, with
//     the state in registers.
//   * Four lanes share a channel, each holding four of its (up to 16)
//     states, so the path's 32 768 (b, d) channels give 131 072 threads;
//     the partial y of the four lanes is summed with two xor shuffles.
//     States past S are zero (A = B = C = 0), so any S <= 16 runs.
//   * Time goes in chunks of 32 steps. The block stages the chunk's u and dt
//     for its channels (coalesced along d) and its rows of B and C (shared
//     by all 64 channels) in shared memory, widened to f32; y is gathered
//     in shared memory and written back coalesced along d.
//   * exp(dt * A) is exp2f(dt * A'), with A' = -exp(a_log) * log2(e) computed
//     once per thread.
//   * Ragged T and D are masked in the kernel (no tile constraint): loads
//     past the ends read zeros, stores past them are skipped.
// Numerics: every input is widened to f32 before any arithmetic, as in the
// plain version (kernels/ref.py::ssm_scan_ref); sums are taken in another
// order. One body serves both input dtypes: each load reads a bf16 or an f32
// element by a flag that is uniform over the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 4;                 // threads per channel
constexpr int SPL = 4;                   // states per lane
constexpr int MAXS = LANES * SPL;        // largest S supported
constexpr int CH = 64;                   // channels per block
constexpr int THREADS = CH * LANES;      // 256
constexpr int TC = 32;                   // time steps per staged chunk
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const void* __restrict__ u, const void* __restrict__ dt,
                const void* __restrict__ b_in, const void* __restrict__ c_in,
                const void* __restrict__ a_log, const void* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ h_out, int T, int D,
                int S, bool in_bf16, bool param_bf16) {
  __shared__ float u_s[TC][CH];
  __shared__ float dt_s[TC][CH];
  __shared__ float y_s[TC][CH];
  __shared__ __align__(16) float b_s[TC][MAXS];
  __shared__ __align__(16) float c_s[TC][MAXS];

  const int tid = threadIdx.x;
  const int c = tid / LANES;             // channel within the block
  const int lane = tid % LANES;
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const int64_t b = blockIdx.y;
  const int s0 = lane * SPL;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    const int s = s0 + k;
    a2[k] = (d < D && s < S) ? -expf(ld(a_log, (int64_t)d * S + s, param_bf16)) * LOG2E
                             : 0.f;
    h[k] = 0.f;
  }
  const float dsk = d < D ? ld(d_skip, d, param_bf16) : 0.f;

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int nt = min(TC, T - t0);
    for (int i = tid; i < TC * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      const bool ok = tt < nt && d0 + cc < D;
      const int64_t e = (b * T + t0 + tt) * D + d0 + cc;
      u_s[tt][cc] = ok ? ld(u, e, in_bf16) : 0.f;
      dt_s[tt][cc] = ok ? ld(dt, e, in_bf16) : 0.f;
    }
    for (int i = tid; i < TC * MAXS; i += THREADS) {
      const int tt = i / MAXS, s = i % MAXS;
      const bool ok = tt < nt && s < S;
      const int64_t e = (b * T + t0 + tt) * S + s;
      b_s[tt][s] = ok ? ld(b_in, e, in_bf16) : 0.f;
      c_s[tt][s] = ok ? ld(c_in, e, in_bf16) : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dt_s[tt][c], uv = u_s[tt][c];
      const float dtu = dtv * uv;
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[tt][s0]);
      const float4 cv = *reinterpret_cast<const float4*>(&c_s[tt][s0]);
      const float bk[SPL] = {bv.x, bv.y, bv.z, bv.w};
      const float ck[SPL] = {cv.x, cv.y, cv.z, cv.w};
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        h[k] = exp2f(dtv * a2[k]) * h[k] + dtu * bk[k];
        acc += h[k] * ck[k];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) y_s[tt][c] = acc + dsk * uv;
    }
    __syncthreads();

    for (int i = tid; i < TC * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      if (tt < nt && d0 + cc < D)
        y[(b * T + t0 + tt) * D + d0 + cc] = y_s[tt][cc];
    }
  }

  if (d < D) {
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      if (s0 + k < S) h_out[(b * D + d) * S + s0 + k] = h[k];
  }
}

}  // namespace

// in_bf16: 1 if u, dt, B, C are bfloat16, 0 if float32; param_bf16: the same
// for a_log and d_skip. Requires B, T, D >= 1 and 1 <= S <= 16 (checked by
// the Python wrapper). Returns cudaGetLastError().
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* b_in,
                               const void* c_in, const void* a_log,
                               const void* d_skip, void* y, void* h_out, int B,
                               int T, int D, int S, int in_bf16, int param_bf16,
                               void* stream) {
  if (S < 1 || S > MAXS) return (int)cudaErrorInvalidValue;
  dim3 grid((D + CH - 1) / CH, B);
  ssm_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      u, dt, b_in, c_in, a_log, d_skip, static_cast<float*>(y),
      static_cast<float*>(h_out), T, D, S, in_bf16 != 0, param_bf16 != 0);
  return (int)cudaGetLastError();
}
