// Backward of the Mamba-1 selective scan from a zero state (K3b):
//   h_t = ā_t h_{t-1} + dt_t u_t B_t,  ā_t = exp(dt_t a),  a = -exp(a_log),
//   y_t = Σ_s h_t C_t + D u_t.
// With g the adjoint of h, walking t from T-1 down to 0,
//   g_t = dy_t C_t + ā_{t+1} g_{t+1}          (g_{T-1} = dh_final + dy C)
//   du_t = dt_t Σ_s g_t B_t + D dy_t,   ddt_t = Σ_s g_t (a ā_t h_{t-1} + u_t B_t)
//   dB_t = Σ_d g_t dt_t u_t,            dC_t = Σ_d dy_t h_t
//   da_log = a Σ_{b,t} g_t dt_t ā_t h_{t-1},   dD = Σ_{b,t} dy_t u_t.
//
// No TPU twin: the JAX package differentiates the lax scan
// src/repro/models/mamba.py::selective_scan (:85) with jax.grad; the forward
// is the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan, ported as
// csrc/ssm_scan.cu (K3). The plain version is kernels/ref.py::
// ssm_scan_bwd_ref. Layouts are K3's: u, dt, dy (B,T,D); B, C (B,T,S);
// a_log (D,S); d_skip (D,); dh_final (B,D,S) f32 or absent (zero).
//
// Bounds on an H100 SXM (falcon-mamba-7b training: B=4, T=2048, D=8192,
// S=16, 1.07e9 state updates):
//   * bytes: u, dt read (bf16, 134 MB each), dy read (f32, 268 MB), du, ddt
//     written (bf16, 134 MB each), the rest under 3 MB: 805 MB, 0.240 ms at
//     3.35 TB/s;
//   * special-function unit: one exp per update is 0.257 ms (ex2 at 16 a
//     clock per SM, 132 SMs, 1.98 GHz); this design takes each exp twice
//     (the checkpoint sweep and the chunk's recompute), 0.51 ms.
// The design is the simple one, right first:
//   * one thread per (batch row, channel, state); a block is 16 channels x
//     16 states and walks 4 such groups of channels (64 channels), so the
//     sums over S are over 16 threads of the block and the sums over D are
//     over the block's 64 channels, then over blocks;
//   * h_{t-1} is never got by inverting the recurrence (ā underflows to 0
//     for trained dt): a forward sweep writes h at the start of every chunk
//     of K = 16 steps to a scratch, and the reverse walk recomputes each
//     chunk's 16 states and their ā in registers from that checkpoint
//     before it walks the chunk backwards;
//   * deterministic: no atomics. Sums over S and over the block's channels
//     go through shared memory in a fixed order; each block writes its
//     partial dB, dC (per step) and da_log, dD (per batch row) to a scratch,
//     and a second kernel sums the partials in block order.
// Steps past T are staged as u = dt = dy = C = B = 0 (ā = 1: the seed
// dh_final passes through unchanged), channels past D and states past S as
// zeros; neither writes an output or adds to a sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXS = 16;                 // states per channel = largest S
constexpr int CPG = 16;                  // channels per group
constexpr int THREADS = CPG * MAXS;      // one (channel, state) per thread
constexpr int G = 4;                     // groups a block walks
constexpr int CB = CPG * G;              // channels per block
constexpr int K = 16;                    // steps per chunk
constexpr int RED_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(K * MAXS == THREADS && K * CPG == THREADS, "one sum per thread");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float param(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void put_param(void* p, int64_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// 2^x on the special-function unit, as K3 takes it: 0 below -126.
__device__ __forceinline__ float ex2_mufu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

struct Smem {
  float u[K][CB], dt[K][CB], dy[K][CB];  // a chunk's inputs, widened
  float b[K][MAXS], c[K][MAXS];
  // per step and thread: g B, the ddt term, g dt u (dB), dy h (dC); the
  // state index padded so both reductions read without bank conflicts
  float part[4][K][CPG][MAXS + 1];
  float du[K][CB], ddt[K][CB];           // a chunk's outputs, in f32
  float accb[K][MAXS], accc[K][MAXS];    // the block's dB, dC of the chunk
  float carry[G][THREADS];               // h (sweep), then ā g (reverse)
  float da[G][THREADS];                  // Σ_t g dt ā h_{t-1}
  float dsk[CB], dd[CB];                 // D, and Σ_t dy u
};

template <typename In>
__device__ __forceinline__ void stage(Smem& sm, const In* u, const In* dt,
                                      const float* dy, const In* b_in,
                                      const In* c_in, int64_t bT, int t0,
                                      int d0, int T, int D, int S, bool rev) {
  const int tid = threadIdx.x;
  for (int i = tid; i < K * CB; i += THREADS) {
    const int k = i / CB, ch = i % CB;
    const bool ok = t0 + k < T && d0 + ch < D;
    const int64_t e = (bT + t0 + k) * D + d0 + ch;
    sm.u[k][ch] = ok ? widen(u[e]) : 0.f;
    sm.dt[k][ch] = ok ? widen(dt[e]) : 0.f;
    if (rev) sm.dy[k][ch] = ok ? dy[e] : 0.f;
  }
  const int k = tid / MAXS, s = tid % MAXS;
  const bool ok = t0 + k < T && s < S;
  const int64_t e = (bT + t0 + k) * S + s;
  sm.b[k][s] = ok ? widen(b_in[e]) : 0.f;
  if (rev) {
    sm.c[k][s] = ok ? widen(c_in[e]) : 0.f;
    sm.accb[k][s] = 0.f;
    sm.accc[k][s] = 0.f;
  }
}

// grid (ceil(D / CB), B); THREADS threads; sizeof(Smem) dynamic shared memory
template <typename In>
__global__ void __launch_bounds__(THREADS, 2)
ssm_scan_bwd_kernel(const In* __restrict__ u, const In* __restrict__ dt,
                    const In* __restrict__ b_in, const In* __restrict__ c_in,
                    const void* __restrict__ a_log,
                    const void* __restrict__ d_skip,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_final,
                    In* __restrict__ du, In* __restrict__ ddt,
                    float* __restrict__ ck, float* __restrict__ part_bc,
                    float* __restrict__ part_da, float* __restrict__ part_dd,
                    int B, int T, int D, int S, bool param_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, s = tid % MAXS, cl = tid / MAXS;
  const int b = blockIdx.y, d0 = blockIdx.x * CB;
  const int64_t bT = (int64_t)b * T;
  const int nc = (T + K - 1) / K;
  const bool s_ok = s < S;

  if (tid < CB) {
    sm.dsk[tid] = d0 + tid < D ? param(d_skip, d0 + tid, param_bf16) : 0.f;
    sm.dd[tid] = 0.f;
  }
  // a of the thread's state in group j (0 where masked)
  auto a_of = [&](int d) {
    return (d < D && s_ok) ? -expf(param(a_log, (int64_t)d * S + s, param_bf16))
                           : 0.f;
  };
  // checkpoint c: h before chunk c + 1, i.e. h_{(c + 1) K - 1}
  auto ck_at = [&](int c, int d) {
    return ck + (((int64_t)c * B + b) * D + d) * S + s;
  };

  // sweep: h at the start of every chunk after the first
#pragma unroll 1
  for (int j = 0; j < G; ++j) sm.carry[j][tid] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc - 1; ++c) {
    stage(sm, u, dt, dy, b_in, c_in, bT, c * K, d0, T, D, S, false);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      const int ch = j * CPG + cl, d = d0 + ch;
      const float a2 = a_of(d) * LOG2E;
      float h = sm.carry[j][tid];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dtk = sm.dt[k][ch];
        h = fmaf(ex2_mufu(dtk * a2), h, (dtk * sm.u[k][ch]) * sm.b[k][s]);
      }
      sm.carry[j][tid] = h;
      if (d < D && s_ok) *ck_at(c, d) = h;
    }
    __syncthreads();
  }

  // reverse walk, chunk by chunk from the last
#pragma unroll 1
  for (int j = 0; j < G; ++j) {
    const int d = d0 + j * CPG + cl;
    sm.carry[j][tid] = (dh_final != nullptr && d < D && s_ok)
                           ? dh_final[((int64_t)b * D + d) * S + s] : 0.f;
    sm.da[j][tid] = 0.f;
  }
#pragma unroll 1
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * K;
    stage(sm, u, dt, dy, b_in, c_in, bT, t0, d0, T, D, S, true);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < G; ++j) {
      const int ch = j * CPG + cl, d = d0 + ch;
      const float a = a_of(d), a2 = a * LOG2E;
      // the chunk's states h_{t0-1} .. h_{t0+K-1} and its ā, recomputed
      float hs[K + 1], ab[K];
      hs[0] = (c > 0 && d < D && s_ok) ? __ldcg(ck_at(c - 1, d)) : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float dtk = sm.dt[k][ch];
        ab[k] = ex2_mufu(dtk * a2);
        hs[k + 1] = fmaf(ab[k], hs[k], (dtk * sm.u[k][ch]) * sm.b[k][s]);
      }
      float carry = sm.carry[j][tid], da = 0.f;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const float dtk = sm.dt[k][ch], uk = sm.u[k][ch], dyk = sm.dy[k][ch];
        const float g = fmaf(dyk, sm.c[k][s], carry);
        const float q = g * ab[k] * hs[k];
        const float gb = g * sm.b[k][s];
        sm.part[0][k][cl][s] = gb;
        sm.part[1][k][cl][s] = fmaf(a, q, uk * gb);
        sm.part[2][k][cl][s] = g * (dtk * uk);
        sm.part[3][k][cl][s] = dyk * hs[k + 1];
        da = fmaf(dtk, q, da);
        carry = ab[k] * g;
      }
      sm.carry[j][tid] = carry;
      sm.da[j][tid] += da;
      __syncthreads();
      {  // du, ddt of (step k, channel cl2): sums over the states
        const int k = tid / CPG, cl2 = tid % CPG, ch2 = j * CPG + cl2;
        float gb = 0.f, x = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < MAXS; ++s2) {
          gb += sm.part[0][k][cl2][s2];
          x += sm.part[1][k][cl2][s2];
        }
        sm.du[k][ch2] = fmaf(sm.dt[k][ch2], gb, sm.dsk[ch2] * sm.dy[k][ch2]);
        sm.ddt[k][ch2] = x;
      }
      {  // dB, dC of (step k, state s2): sums over the group's channels
        const int k = tid / MAXS, s2 = tid % MAXS;
        float pb = 0.f, pc = 0.f;
#pragma unroll
        for (int c2 = 0; c2 < CPG; ++c2) {
          pb += sm.part[2][k][c2][s2];
          pc += sm.part[3][k][c2][s2];
        }
        sm.accb[k][s2] += pb;
        sm.accc[k][s2] += pc;
      }
      __syncthreads();
    }
    for (int i = tid; i < K * CB; i += THREADS) {
      const int k = i / CB, ch = i % CB;
      if (t0 + k < T && d0 + ch < D) {
        const int64_t e = (bT + t0 + k) * D + d0 + ch;
        du[e] = narrow<In>(sm.du[k][ch]);
        ddt[e] = narrow<In>(sm.ddt[k][ch]);
      }
    }
    if (tid < CB) {
      float acc = sm.dd[tid];
#pragma unroll
      for (int k = 0; k < K; ++k) acc = fmaf(sm.dy[k][tid], sm.u[k][tid], acc);
      sm.dd[tid] = acc;
    }
    {
      const int k = tid / MAXS, s2 = tid % MAXS;
      if (t0 + k < T && s2 < S) {
        const int64_t nbc = (int64_t)B * T * S;
        const int64_t e = (bT + t0 + k) * S + s2;
        part_bc[(int64_t)blockIdx.x * nbc + e] = sm.accb[k][s2];
        part_bc[((int64_t)gridDim.x + blockIdx.x) * nbc + e] = sm.accc[k][s2];
      }
    }
    __syncthreads();
  }

#pragma unroll 1
  for (int j = 0; j < G; ++j) {
    const int d = d0 + j * CPG + cl;
    if (d < D && s_ok) part_da[((int64_t)b * D + d) * S + s] = sm.da[j][tid];
  }
  if (tid < CB && d0 + tid < D) part_dd[(int64_t)b * D + d0 + tid] = sm.dd[tid];
}

// The partials summed in a fixed order: dB, dC over the nblk blocks along D
// (block order), da_log and dD over the batch rows (row order); da_log
// multiplied by a once, after the sum.
template <typename In>
__global__ void __launch_bounds__(RED_THREADS)
ssm_scan_bwd_reduce_kernel(const float* __restrict__ part_bc,
                           const float* __restrict__ part_da,
                           const float* __restrict__ part_dd,
                           const void* __restrict__ a_log, In* __restrict__ db,
                           In* __restrict__ dc, void* __restrict__ da_log,
                           void* __restrict__ dd, int B, int T, int D, int S,
                           int nblk, bool param_bf16) {
  const int64_t nbc = (int64_t)B * T * S, nds = (int64_t)D * S;
  const int64_t total = 2 * nbc + nds + D;
  for (int64_t i = (int64_t)blockIdx.x * RED_THREADS + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * RED_THREADS) {
    if (i < 2 * nbc) {
      const int q = (int)(i / nbc);
      const int64_t r = i % nbc;
      const float* p = part_bc + (int64_t)q * nblk * nbc + r;
      float acc = 0.f;
      for (int k = 0; k < nblk; ++k) acc += p[(int64_t)k * nbc];
      (q ? dc : db)[r] = narrow<In>(acc);
    } else if (i < 2 * nbc + nds) {
      const int64_t r = i - 2 * nbc;
      float acc = 0.f;
      for (int k = 0; k < B; ++k) acc += part_da[(int64_t)k * nds + r];
      put_param(da_log, r, -expf(param(a_log, r, param_bf16)) * acc, param_bf16);
    } else {
      const int64_t r = i - 2 * nbc - nds;
      float acc = 0.f;
      for (int k = 0; k < B; ++k) acc += part_dd[(int64_t)k * D + r];
      put_param(dd, r, acc, param_bf16);
    }
  }
}

template <typename In>
int launch(const void* u, const void* dt, const void* b_in, const void* c_in,
           const void* a_log, const void* d_skip, const float* dy,
           const float* dh, void* du, void* ddt, void* db, void* dc,
           void* da_log, void* dd, float* ck, float* part_bc, float* part_da,
           float* part_dd, int B, int T, int D, int S, bool param_bf16,
           cudaStream_t st) {
  auto kern = ssm_scan_bwd_kernel<In>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  const int nblk = (D + CB - 1) / CB;
  kern<<<dim3(nblk, B), THREADS, sizeof(Smem), st>>>(
      static_cast<const In*>(u), static_cast<const In*>(dt),
      static_cast<const In*>(b_in), static_cast<const In*>(c_in), a_log, d_skip,
      dy, dh, static_cast<In*>(du), static_cast<In*>(ddt), ck, part_bc,
      part_da, part_dd, B, T, D, S, param_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = 2 * (int64_t)B * T * S + (int64_t)D * S + D;
  const int64_t want = (total + RED_THREADS - 1) / RED_THREADS;
  const int blocks = (int)(want < 65535 ? want : 65535);
  ssm_scan_bwd_reduce_kernel<In><<<blocks, RED_THREADS, 0, st>>>(
      part_bc, part_da, part_dd, a_log, static_cast<In*>(db),
      static_cast<In*>(dc), da_log, dd, B, T, D, S, nblk, param_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes, in floats, that the caller allocates (the Python wrapper
// does): ck (ceil(T/16) - 1) * B * D * S; part_bc 2 * ceil(D/64) * B * T * S;
// part_da B * D * S; part_dd B * D. dh may be null (a zero cotangent).
// in_bf16: 1 if u, dt, B, C (and du, ddt, dB, dC) are bfloat16, 0 if float32;
// param_bf16 the same for a_log, d_skip (and da_log, dD). Requires B, T,
// D >= 1 and 1 <= S <= 16 (checked by the Python wrapper). Returns the first
// CUDA error of the two launches, or 0.
extern "C" int ssm_scan_bwd_launch(
    const void* u, const void* dt, const void* b_in, const void* c_in,
    const void* a_log, const void* d_skip, const void* dy, const void* dh,
    void* du, void* ddt, void* db, void* dc, void* da_log, void* dd, void* ck,
    void* part_bc, void* part_da, void* part_dd, int B, int T, int D, int S,
    int in_bf16, int param_bf16, void* stream) {
  if (S < 1 || S > MAXS) return (int)cudaErrorInvalidValue;
  const float* dyf = static_cast<const float*>(dy);
  const float* dhf = static_cast<const float*>(dh);
  float *ckf = static_cast<float*>(ck), *pbc = static_cast<float*>(part_bc),
        *pda = static_cast<float*>(part_da), *pdd = static_cast<float*>(part_dd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(u, dt, b_in, c_in, a_log, d_skip, dyf, dhf, du,
                                 ddt, db, dc, da_log, dd, ckf, pbc, pda, pdd, B,
                                 T, D, S, param_bf16 != 0, st);
  return launch<float>(u, dt, b_in, c_in, a_log, d_skip, dyf, dhf, du, ddt, db,
                       dc, da_log, dd, ckf, pbc, pda, pdd, B, T, D, S,
                       param_bf16 != 0, st);
}
