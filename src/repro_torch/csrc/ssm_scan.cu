// Mamba-1 selective scan with an f32 state and a zero initial state:
//   h = exp(dt * A) * h + (dt * u) * B,   y = h . C + D * u,   A = -exp(a_log).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel, pallas_call at :77). Layouts are the reference's: u, dt
// (B,T,D); B, C (B,T,S); a_log (D,S); d_skip (D,); outputs y (B,T,D) f32 and
// h_final (B,D,S) f32, all contiguous.
//
// Bounds on an H100 SXM (falcon-mamba-7b prefill: B=4, T=2048, D=8192, S=16,
// E = B*T*D*S = 1.07e9 state updates):
//   * bytes: u and dt read once (268 MB in bf16), y written once (268 MB in
//     f32), the rest 3 MB: 0.161 ms at 3.35 TB/s;
//   * special-function unit: one exp per update; ex2 runs at 16 a clock per
//     SM, 0.257 ms at 132 SMs and 1.98 GHz if every exp goes there;
//   * issue: 128 thread-instructions a clock per SM; an update needs at least
//     4 FP32 instructions (dt*A', (dt*u)*B, the FMA into h, the FMA into y),
//     0.128 ms before the exp, the loads and the stores.
// What the design does about each:
//   * Issue: one thread owns one (batch row, channel) and all its (up to 16)
//     states, so y needs no reduction across threads (no shuffle, no shared
//     store, no barrier per step), and its 16 states are 16 independent
//     chains. The input dtype is a template parameter and the time loop is
//     unrolled over chunks of TC steps, so loads need no dtype branch and
//     every register index and shared-memory offset is fixed at compile time;
//     the per-step overhead left is the broadcast reads of B and C, the read
//     of (u, dt) and one predicated store of y.
//   * Special-function unit: every exp is one MUFU.EX2 (ex2.approx.ftz), and
//     exp(dt * A) of a step is taken one step before the step uses it, so
//     the exps queue behind the previous step's FMAs instead of in front of
//     their own. Issue, not the MUFU, is the tighter limit of this design:
//     moving a share of the exps onto the FMA pipes as a polynomial did not
//     make it measurably faster.
//   * Bytes: each warp stages its own 32 channels one chunk ahead: 16-byte
//     loads of u and dt, issued at the start of a chunk and written to shared
//     memory (widened to f32) at its end, so a whole chunk of arithmetic runs
//     under each load; B and C of a step, which every channel of the batch
//     row shares, are staged with them and read as broadcasts. Warps sync
//     only with themselves. A warp's y store writes 128 neighbouring bytes.
// Under grad (CKPT) the kernel also writes h after every CKH-th step that a
// step follows, the 16 states of a (batch row, channel) in state order, for
// the backward (csrc/ssm_scan_bwd.cu), which recomputes the states between
// them: 4 16-byte stores a lane every 8 steps, beside the per-step y
// stores. The serving instance (CKPT false) is the same code without them.
// States past S have A = B = C = 0, so they stay 0 and add nothing: any
// S <= 16 runs. Channels past D, and steps past T (staged as dt = u = 0, so
// h is kept exactly), are computed but not stored.
// Numerics: every input is widened to f32 before any arithmetic, as in the
// plain version (kernels/ref.py::ssm_scan_ref); exp(dt*A) is 2^(dt*A'), with
// A' = -exp(a_log) * log2(e) computed once per state; sums are taken in
// another order. ex2.approx.ftz is within ~2e-7 relative of 2^x and gives 0
// where 2^x is below the smallest normal f32 (x < -126), as exp underflows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXS = 16;                 // states per channel = largest S
constexpr int THREADS = 128;             // one channel per thread
constexpr int WARPS = THREADS / 32;
constexpr int TC = 16;                   // time steps per chunk
constexpr int CKH = 8;                   // steps between checkpoints of h (CKPT)
static_assert(TC % CKH == 0, "checkpoints fall inside a chunk");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float param(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 2^x on the special-function unit: one MUFU.EX2; 0 below -126 (flushed).
__device__ __forceinline__ float ex2_mufu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// *p = v where ok, as one predicated store: a branch around a plain store
// would end the basic block at every step and keep the compiler from
// overlapping one step's arithmetic with the next one's.
__device__ __forceinline__ void store_if(float* p, float v, bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p st.global.f32 [%0], %1;\n}"
      :: "l"(p), "f"(v), "r"((int)ok));
}

// the four floats at p where ok, one predicated 16-byte store
__device__ __forceinline__ void store4_if(float* p, float a, float b, float c,
                                          float d, bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p st.global.v4.f32 [%0], {%1, %2, %3, %4};\n}"
      :: "l"(p), "f"(a), "f"(b), "f"(c), "f"(d), "r"((int)ok));
}

// Loads of the chunk ahead, as volatile asm and without .nc, so that neither
// the compiler nor ptxas moves them past the per-step stores of y (which may
// alias them) and they are issued at the start of the chunk: plain or .nc
// loads get sunk to the end of the chunk, next to the shared-memory stores
// that consume them, where every chunk waits out a device-memory latency.
// Each returns 0 where !ok.
__device__ __forceinline__ uint4 ld16_if(const void* p, bool ok) {
  uint4 v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @p ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "r"((int)ok));
  return v;
}
__device__ __forceinline__ float ld_if(const float* p, bool ok) {
  float v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b32 %0, 0;\n"
      " @p ld.global.f32 %0, [%1];\n}" : "=f"(v) : "l"(p), "r"((int)ok));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_if(const __nv_bfloat16* p, bool ok) {
  unsigned short v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n mov.b16 %0, 0;\n"
      " @p ld.global.b16 %0, [%1];\n}" : "=h"(v) : "l"(p), "r"((int)ok));
  return __ushort_as_bfloat16(v);
}

// The EPV inputs of one 16-byte load, widened to f32.
template <typename In>
struct Vec {
  static constexpr int EPV = 16 / sizeof(In);
  __device__ __forceinline__ static void widen(const uint4& v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if constexpr (sizeof(In) == 2) {     // bf16: the low half comes first
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
    }
  }
};

// VEC: D is a multiple of 8, so every row of u and dt is 16-byte aligned and
// is staged with 16-byte loads; otherwise element by element. The path needs
// two blocks an SM; asking for three caps registers at 170, under which ptxas
// schedules the time loop with fewer stall cycles than with no cap.
template <typename In, bool VEC, bool CKPT>
__global__ void __launch_bounds__(THREADS, 3)
ssm_scan_kernel(const In* __restrict__ u, const In* __restrict__ dt,
                const In* __restrict__ b_in, const In* __restrict__ c_in,
                const void* __restrict__ a_log, const void* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ h_out,
                float* __restrict__ ck, int T, int D, int S, bool param_bf16) {
  // per warp and step of a chunk: (u, dt) of each channel, and B then C
  // (zero past S), widened to f32; two chunks, one read while the other is
  // filled
  __shared__ __align__(16) float2 ud_s[WARPS][2][TC][32];
  __shared__ __align__(16) float bc_s[WARPS][2][TC][2 * MAXS];
  constexpr int EPV = Vec<In>::EPV;
  constexpr int VPR = 32 / EPV;                  // 16-byte vectors per row
  constexpr int NV = TC * VPR / 32;              // staged per lane, each
  static_assert(NV * 32 == TC * VPR, "a chunk's rows split evenly over lanes");

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int dw = blockIdx.x * THREADS + w * 32;  // the warp's first channel
  const int d = dw + lane;
  const bool d_ok = d < D;
  const int64_t bT = (int64_t)blockIdx.y * T;

  float a2[MAXS], h[MAXS];
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    a2[s] = (d_ok && s < S)
                ? -expf(param(a_log, (int64_t)d * S + s, param_bf16)) * LOG2E
                : 0.f;
    h[s] = 0.f;
  }
  const float dsk = d_ok ? param(d_skip, d, param_bf16) : 0.f;

  // staging registers, loaded at the start of a chunk for the next one and
  // written to shared memory at its end. VEC: vector k is row v / VPR,
  // channels dw + (v % VPR) * EPV.., v = lane + 32 k; else row k of the
  // lane's channel. B/C: step k, B (lane < 16) or C, state lane % 16.
  uint4 uv_r[NV], dv_r[NV];
  In u_r[TC], dt_r[TC], bc_r[TC];
  const In* bc_src = lane < MAXS ? b_in : c_in;
  const int bc_st = lane % MAXS;
  auto fetch = [&](int t0) {
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k, row = v / VPR, col = v % VPR * EPV;
        const bool ok = t0 + row < T && dw + col < D;
        const int64_t e = (bT + t0 + row) * D + dw + col;
        uv_r[k] = ld16_if(u + e, ok);
        dv_r[k] = ld16_if(dt + e, ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        const bool ok = d_ok && t0 + k < T;
        const int64_t e = (bT + t0 + k) * D + d;
        u_r[k] = ld_if(u + e, ok);
        dt_r[k] = ld_if(dt + e, ok);
      }
    }
#pragma unroll
    for (int k = 0; k < TC; ++k)
      bc_r[k] = ld_if(bc_src + (bT + t0 + k) * S + bc_st, bc_st < S && t0 + k < T);
  };
  auto stage = [&](int buf) {
    if constexpr (VEC) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int v = lane + 32 * k, row = v / VPR, col = v % VPR * EPV;
        float fu[EPV], fd[EPV];
        Vec<In>::widen(uv_r[k], fu);
        Vec<In>::widen(dv_r[k], fd);
        float4* dst = reinterpret_cast<float4*>(&ud_s[w][buf][row][col]);
#pragma unroll
        for (int i = 0; i < EPV / 2; ++i)
          dst[i] = make_float4(fu[2 * i], fd[2 * i], fu[2 * i + 1], fd[2 * i + 1]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < TC; ++k)
        ud_s[w][buf][k][lane] = make_float2(widen(u_r[k]), widen(dt_r[k]));
    }
#pragma unroll
    for (int k = 0; k < TC; ++k) bc_s[w][buf][k][lane] = widen(bc_r[k]);
  };

  fetch(0);
  stage(0);
  __syncwarp();
  float ea[MAXS];                        // exp(dt * A) of the coming step
  int buf = 0;
  for (int t0 = 0; t0 < T; t0 += TC, buf ^= 1) {
    fetch(t0 + TC);                      // arrives while this chunk runs
    float* yc = y + (bT + t0) * D + d;
    const int n = T - t0;                // steps left from t0
    const float dt0 = ud_s[w][buf][0][lane].y;
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      const float x = dt0 * a2[s];
      ea[s] = ex2_mufu(x);
    }
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const float4* bc4 = reinterpret_cast<const float4*>(bc_s[w][buf][tt]);
      float bc[2 * MAXS];
#pragma unroll
      for (int q = 0; q < 2 * MAXS / 4; ++q) {
        const float4 v = bc4[q];
        bc[4 * q] = v.x; bc[4 * q + 1] = v.y;
        bc[4 * q + 2] = v.z; bc[4 * q + 3] = v.w;
      }
      const float2 ud = ud_s[w][buf][tt][lane];
      const float dtu = ud.y * ud.x;
      const float dtn = tt + 1 < TC ? ud_s[w][buf][tt + 1][lane].y : 0.f;
      float yv = dsk * ud.x;
#pragma unroll
      for (int s = 0; s < MAXS; ++s) {
        h[s] = fmaf(ea[s], h[s], dtu * bc[s]);
        yv = fmaf(h[s], bc[MAXS + s], yv);
        if (tt + 1 < TC) {
          const float x = dtn * a2[s];
          ea[s] = ex2_mufu(x);
        }
      }
      store_if(yc + tt * D, yv, d_ok && tt < n);
      if constexpr (CKPT) {
        if (tt % CKH == CKH - 1) {         // checkpoint (t0 + tt + 1) / CKH - 1
          float* dst = ck + (((int64_t)((t0 + tt + 1) / CKH - 1) * gridDim.y
                              + blockIdx.y) * D + d) * MAXS;
#pragma unroll
          for (int q = 0; q < MAXS / 4; ++q)
            store4_if(dst + 4 * q, h[4 * q], h[4 * q + 1], h[4 * q + 2],
                      h[4 * q + 3], d_ok && tt + 1 < n);
        }
      }
    }
    stage(buf ^ 1);                      // read last in the previous chunk
    __syncwarp();
  }

  if (d_ok) {
#pragma unroll
    for (int s = 0; s < MAXS; ++s)
      if (s < S) h_out[((int64_t)blockIdx.y * D + d) * S + s] = h[s];
  }
}

template <typename In, bool CKPT>
void launch(const void* u, const void* dt, const void* b_in, const void* c_in,
            const void* a_log, const void* d_skip, float* y, float* h_out,
            float* ck, int B, int T, int D, int S, bool param_bf16,
            cudaStream_t st) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  const In *ui = static_cast<const In*>(u), *dti = static_cast<const In*>(dt),
           *bi = static_cast<const In*>(b_in), *ci = static_cast<const In*>(c_in);
  if (D % 8 == 0)
    ssm_scan_kernel<In, true, CKPT><<<grid, THREADS, 0, st>>>(
        ui, dti, bi, ci, a_log, d_skip, y, h_out, ck, T, D, S, param_bf16);
  else
    ssm_scan_kernel<In, false, CKPT><<<grid, THREADS, 0, st>>>(
        ui, dti, bi, ci, a_log, d_skip, y, h_out, ck, T, D, S, param_bf16);
}

}  // namespace

// in_bf16: 1 if u, dt, B, C are bfloat16, 0 if float32; param_bf16: the same
// for a_log and d_skip. ck: null, or floor((T - 1) / 8) * B * D * 16 floats
// for h after every 8th step that a step follows ([m][b][d][16]). Requires
// B, T, D >= 1 and 1 <= S <= 16 (checked by the Python wrapper). Returns
// cudaGetLastError().
extern "C" int ssm_scan_launch(const void* u, const void* dt, const void* b_in,
                               const void* c_in, const void* a_log,
                               const void* d_skip, void* y, void* h_out,
                               void* ck, int B, int T, int D, int S, int in_bf16,
                               int param_bf16, void* stream) {
  if (S < 1 || S > MAXS) return (int)cudaErrorInvalidValue;
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  float* ckf = static_cast<float*>(ck);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pb = param_bf16 != 0;
  if (in_bf16) {
    if (ckf)
      launch<__nv_bfloat16, true>(u, dt, b_in, c_in, a_log, d_skip, yf, hf, ckf,
                                  B, T, D, S, pb, st);
    else
      launch<__nv_bfloat16, false>(u, dt, b_in, c_in, a_log, d_skip, yf, hf,
                                   ckf, B, T, D, S, pb, st);
  } else {
    if (ckf)
      launch<float, true>(u, dt, b_in, c_in, a_log, d_skip, yf, hf, ckf, B, T,
                          D, S, pb, st);
    else
      launch<float, false>(u, dt, b_in, c_in, a_log, d_skip, yf, hf, ckf, B, T,
                           D, S, pb, st);
  }
  return (int)cudaGetLastError();
}
