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
//   * f32 arithmetic: at least 18 operations an update (an FMA counts 2)
//     and 8 per (b, t, d): 0.297 ms at 67 TFLOP/s;
//   * special-function unit: one exp an update, the exps this design takes,
//     is 0.257 ms (ex2 at 16 a clock per SM, 132 SMs, 1.98 GHz);
//   * bytes: u, dt read (bf16, 134 MB each), dy read (f32, 268 MB), du, ddt
//     written (bf16, 134 MB each), the rest under 3 MB: 0.240 ms at 3.35
//     TB/s. The design moves about twice that: it reads the forward
//     kernel's checkpoints of h, every 8 steps (535 MB), and writes the
//     per-block dB, dC partials (134 MB) that a second kernel sums.
// What limits a backward scan past those is the instruction rate and the
// queue of shared-memory and shuffle instructions: every sum across threads
// goes through it, and an H100 SM takes about one such instruction a clock.
// Here the walk takes ~27 instructions an update (the arithmetic ~14 of
// them), with ~5 shared-memory or shuffle accesses; with 8 warps an SM,
// about half the dispatch slots go unused.
// What the design does about each:
//   * States in registers, sums by shuffles. A lane owns 4 states of one
//     channel; 4 lanes hold a channel's 16 states and a warp 8 channels
//     (lane = 4 c + ls: channel c, state quad ls). du and ddt are sums over
//     the lane's 4 states in registers, then over the channel's 4 lanes by
//     two shuffles. dB and dC, sums over channels, take a reduce-scatter
//     over the warp's 8 channels: three shuffle rounds, each halving what a
//     lane holds, leave each of the 32 lanes with one (quantity, state) of
//     the step; a sum over the 8 warps in shared memory, in warp order, once
//     a chunk of 16 steps; and a sum over blocks, in block order, by a
//     second kernel. Register j of a lane holds state 4 ls + (j ^ (c & 3)),
//     so the value a lane keeps and the one its partner sends sit in the
//     same register and no lane selects at run time; B and C are staged in
//     four copies, one per such order, so a lane reads its states as one
//     16-byte load. A step of 4 updates a lane takes 9 shuffles, 3 16-byte
//     shared loads in the walk and 2 in the recompute, and 2 shared stores
//     (against ~20 accesses an update with one thread per (channel, state)
//     and every sum through shared memory).
//   * Special-function unit: every exp is one MUFU.EX2 (ex2.approx.ftz),
//     as K3 takes it, one an update. The walk takes none: each half chunk's
//     ā and h, recomputed from its checkpoint, stay in registers for it,
//     and the earlier half is recomputed a step at a time beside the later
//     half's walk, so its exps overlap the walk's shuffles.
//   * Warps, barriers and waves: a block is 8 warps (64 channels of one
//     batch row), 1 block an SM for its registers (8 warps). A warp stages
//     its own inputs (B and C included) and syncs with itself only; the one
//     wait across warps is for the block's dB, dC of a chunk, on an
//     mbarrier that each thread arrives at after writing them, three
//     chunks in flight, so warps drift by up to a chunk. The grid is
//     (ceil(D / 64), B): 512 blocks at falcon-mamba-7b's shape (4 waves of
//     132), 200 at hymba-1.5b's D = 3200 (2 waves, 0.76 of the slots used).
//   * Staging: the next chunk (u, dt, dy with 8- or 16-byte loads, B and C
//     a row a lane, the two checkpoints) is loaded at the start of the
//     current one, as volatile asm that the compiler cannot sink, and
//     written to shared memory (widened, with dt u) once. Every shared
//     operand of a walk step is loaded a step ahead, before the step's
//     shared stores.
//   * h_{t-1} is never got by inverting the recurrence (ā underflows to 0
//     for trained dt): the forward kernel (csrc/ssm_scan.cu) writes h at
//     every 8th step under grad, and the walk recomputes each half chunk's
//     8 states and their ā from that checkpoint before it walks them
//     backwards.
//   * Deterministic: no atomics. Every sum runs in an order fixed by the
//     shape alone (the lane order of the shuffles, warp order, block order,
//     batch-row order), so two runs give the same bits.
// Steps past T are staged as u = dt = dy = C = B = 0 (ā = 1: the seed
// dh_final passes through unchanged), channels past D and states past S as
// zeros; neither writes an output or adds to a sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXS = 16;                 // states per channel = largest S
constexpr int NJ = 4;                    // states a lane holds
constexpr int LPC = MAXS / NJ;           // lanes a channel takes
constexpr int CPW = 32 / LPC;            // channels a warp takes
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CB = CPW * WARPS;          // channels a block takes
constexpr int K = 16;                    // steps a chunk of the walk stages
constexpr int H = 8;                     // steps between checkpoints of h
constexpr int BCW = 8 * MAXS + 4;        // floats a step of a warp's B and C
constexpr int NRED = 3;                  // chunks of dB, dC partials in flight
constexpr int RED_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(2 * K == 32 && K == 2 * H, "a row per two lanes, two halves a chunk");
constexpr int BSUM = K * 2 * MAXS / THREADS;   // the block's dB, dC a thread sums
static_assert(BSUM * THREADS == K * 2 * MAXS, "the block's dB, dC split evenly");
static_assert(CPW == 8 && NJ == 4, "the shuffle rounds assume 8 channels x 4 states");

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

// Loads of the chunk ahead, as volatile asm and without .nc (as in K3), so
// that they go out at the start of the chunk and are not sunk to the shared
// stores that consume them. Each returns 0 where !ok.
__device__ __forceinline__ uint4 ld16_if(const void* p, bool ok) {
  uint4 v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @p ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n}"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "r"((int)ok));
  return v;
}
__device__ __forceinline__ uint2 ld8_if(const void* p, bool ok) {
  uint2 v;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n mov.b32 %0, 0;\n mov.b32 %1, 0;\n"
      " @p ld.global.v2.u32 {%0, %1}, [%2];\n}"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "r"((int)ok));
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

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// Four neighbouring inputs of one row from p, raw (bf16: two to a word, the
// low half first), zero where !ok; VEC: one 8- or 16-byte load, else one
// load an element, the first n of them inside the row.
template <typename In, bool VEC>
__device__ __forceinline__ uint4 load4(const In* p, bool ok, int n) {
  if constexpr (VEC) {
    if constexpr (sizeof(In) == 2) {
      const uint2 v = ld8_if(p, ok);
      return make_uint4(v.x, v.y, 0u, 0u);
    } else {
      return ld16_if(p, ok);
    }
  } else {
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = bits(ld_if(p + i, ok && i < n));
    if constexpr (sizeof(In) == 2)
      return make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), 0u, 0u);
    else
      return make_uint4(e[0], e[1], e[2], e[3]);
  }
}
template <typename In>
__device__ __forceinline__ void widen4(const uint4& v, float* o) {
  if constexpr (sizeof(In) == 2) {
    o[0] = __uint_as_float(v.x << 16);
    o[1] = __uint_as_float(v.x & 0xffff0000u);
    o[2] = __uint_as_float(v.y << 16);
    o[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
}
// Four outputs of one row to p where ok (each rounded once): VEC one store,
// else one an element, the first n of them.
template <typename In, bool VEC>
__device__ __forceinline__ void store4(In* p, const float* v, bool ok, int n) {
  if constexpr (VEC) {
    if (!ok) return;
    if constexpr (sizeof(In) == 2) {
      uint2 w;
      w.x = bits(narrow<In>(v[0])) | (bits(narrow<In>(v[1])) << 16);
      w.y = bits(narrow<In>(v[2])) | (bits(narrow<In>(v[3])) << 16);
      *reinterpret_cast<uint2*>(p) = w;
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ok && i < n) p[i] = narrow<In>(v[i]);
  }
}

// v[i ^ p] for i = 0..3: a lane's 4 registers in state order, or 4 states
// in the lane's register order (the map is its own inverse)
__device__ __forceinline__ float4 xor_perm(float v0, float v1, float v2, float v3,
                                           int p) {
  const bool s1 = p & 1;
  const float a0 = s1 ? v1 : v0, a1 = s1 ? v0 : v1, a2 = s1 ? v3 : v2,
              a3 = s1 ? v2 : v3;
  return (p & 2) ? make_float4(a2, a3, a0, a1) : make_float4(a0, a1, a2, a3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// arrive: release of what this thread wrote to shared memory before it
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Returns once the phase of parity `parity` has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// The 16 values of a row of B or C (S of them inside the row) from p, raw
// (bf16: two to a word): S == 16 as 16-byte loads, else one load a value.
template <typename In>
struct Row16 {
  static constexpr int NV = sizeof(In);          // 16-byte words: 2 or 4
  uint4 v[NV];
  __device__ __forceinline__ void load(const In* p, int S, bool ok) {
    if (S == MAXS) {
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = ld16_if(p + i * (16 / sizeof(In)), ok);
    } else {
      uint32_t e[MAXS];
#pragma unroll
      for (int s = 0; s < MAXS; ++s) e[s] = bits(ld_if(p + s, ok && s < S));
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if constexpr (sizeof(In) == 2)
          v[i] = make_uint4(e[8 * i] | (e[8 * i + 1] << 16), e[8 * i + 2] | (e[8 * i + 3] << 16),
                            e[8 * i + 4] | (e[8 * i + 5] << 16), e[8 * i + 6] | (e[8 * i + 7] << 16));
        else
          v[i] = make_uint4(e[4 * i], e[4 * i + 1], e[4 * i + 2], e[4 * i + 3]);
      }
    }
  }
  // the row widened, written as the four copies a lane reads: copy cp holds
  // state 4 q + (j ^ cp) at cp * 16 + 4 q + j
  __device__ __forceinline__ void stage(float* dst) const {
    float f[MAXS];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(In) == 2) {   // the low half first
          f[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
          f[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        } else {
          f[4 * i + k] = __uint_as_float(w[k]);
        }
      }
    }
#pragma unroll
    for (int cp = 0; cp < 4; ++cp)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(dst + cp * MAXS + 4 * q) =
            make_float4(f[4 * q + (0 ^ cp)], f[4 * q + (1 ^ cp)], f[4 * q + (2 ^ cp)],
                        f[4 * q + (3 ^ cp)]);
  }
};

// A warp's staging: {dt, dt u, u, dy} of each step and of the
// warp's channels, channel c of step k at slot c ^ (k & 3), so that neither
// the staging stores nor a step's reads conflict on a bank; B then C of
// each step, four copies each (copy p in the register order of the lanes
// with c & 3 == p), the row padded to BCW floats.
struct WarpWalk {
  float4 ud[K][CPW];
  float bc[K][BCW];
};
struct Smem {
  WarpWalk stage[WARPS];                  // a warp's own, restaged by it
  // per warp and step, the warp's dB (q = 0) and dC (q = 1) of each state,
  // at q * 16 + s; NRED chunks in flight
  float red[NRED][WARPS][K][2 * MAXS];
  float out[WARPS][K][2][CPW];            // du, ddt of the warp's channels
  uint64_t bar[NRED];                     // chunk n's red: all threads wrote it
};

// grid (ceil(D / CB), B); THREADS threads; sizeof(Smem) dynamic shared
// memory. VEC: D is a multiple of 4, so a lane's four channels of a row are
// one aligned 8- or 16-byte access.
template <typename In, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
ssm_scan_bwd_kernel(const In* __restrict__ u, const In* __restrict__ dt,
                    const In* __restrict__ b_in, const In* __restrict__ c_in,
                    const void* __restrict__ a_log,
                    const void* __restrict__ d_skip,
                    const float* __restrict__ dy,
                    const float* __restrict__ dh_final,
                    In* __restrict__ du, In* __restrict__ ddt,
                    const float* __restrict__ ck, float* __restrict__ part_bc,
                    float* __restrict__ part_da, float* __restrict__ part_dd,
                    int B, int T, int D, int S, bool param_bf16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ls = lane & 3, c = lane >> 2, p = c & 3;
  const int b = blockIdx.y, d0 = blockIdx.x * CB, dw = d0 + CPW * w;
  const int d = dw + c;                   // the lane's channel
  const bool d_ok = d < D;
  const int64_t bT = (int64_t)b * T;
  const int nc = (T + K - 1) / K;
  WarpWalk& ww = sm.stage[w];            // the warp's own staging

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < NRED; ++i) mbar_init(&sm.bar[i], THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // register j holds state 4 ls + (j ^ p)
  int st[NJ];
  float a[NJ], a2[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    st[j] = 4 * ls + (j ^ p);
    a[j] = (d_ok && st[j] < S)
               ? -expf(param(a_log, (int64_t)d * S + st[j], param_bf16)) : 0.f;
    a2[j] = a[j] * LOG2E;
  }
  // the du lanes (ls < 2) add D dy
  const float dskm = (d_ok && ls < 2) ? param(d_skip, d, param_bf16) : 0.f;
  // checkpoint m: h after step H (m + 1) - 1, kept where a step follows it,
  // the lane's 4 states in state order, as the forward kernel wrote them
  auto ck_at = [&](int m) {
    return ck + (((int64_t)m * B + b) * D + d) * MAXS + NJ * ls;
  };
  auto ck_ok = [&](int m) { return m >= 0 && H * (m + 1) < T && d_ok; };

  // The walk, chunk by chunk from the last, each warp on its own
  // but for the block's dB, dC. Lane (k = lane / 2, half) loads u, dt, dy
  // of step k for the warp's channels 4 half .. 4 half + 3, and B (half 0)
  // or C (half 1) of step k.
  uint4 ur, dr, yr;
  Row16<In> bcr;
  const int kl = lane >> 1, hl = lane & 1, dq = dw + 4 * hl;
  auto fetch = [&](int t0) {
    const bool ok = t0 + kl < T;
    const bool okq = ok && (!VEC || dq < D);
    const int64_t e = (bT + t0 + kl) * D + dq;
    ur = load4<In, VEC>(u + e, okq, D - dq);
    dr = load4<In, VEC>(dt + e, okq, D - dq);
    yr = load4<float, VEC>(dy + e, okq, D - dq);
    bcr.load((hl ? c_in : b_in) + (bT + t0 + kl) * S, S, ok);
  };
  auto stage = [&]() {
    float fu[4], fd[4], fy[4];
    widen4<In>(ur, fu);
    widen4<In>(dr, fd);
    widen4<float>(yr, fy);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ww.ud[kl][(4 * hl + i) ^ (kl & 3)] = make_float4(fd[i], fd[i] * fu[i], fu[i], fy[i]);
    bcr.stage(&ww.bc[kl][hl * 4 * MAXS]);
  };
  // the start states of chunk cc's two halves: checkpoints 2 cc - 1, 2 cc
  uint4 hq[2];
  auto hfetch = [&](int cc) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = 2 * cc - 1 + hf;
      hq[hf] = ld16_if(ck_ok(m) ? ck_at(m) : ck, ck_ok(m));
    }
  };
  // the block's dB, dC of a chunk: the warps' sums of red[i], added in warp
  // order once every thread has written its own
  auto block_sum = [&](int i, uint32_t parity, int t0) {
    mbar_wait(&sm.bar[i], parity);
#pragma unroll
    for (int r = 0; r < BSUM; ++r) {
      const int o = tid + r * THREADS, k = o / (2 * MAXS), q = o % (2 * MAXS);
      float v = sm.red[i][0][k][q];
#pragma unroll
      for (int wi = 1; wi < WARPS; ++wi) v += sm.red[i][wi][k][q];
      const int s = q % MAXS;
      if (t0 + k < T && s < S)
        part_bc[((int64_t)(q / MAXS) * gridDim.x + blockIdx.x) * B * T * S
                + (bT + t0 + k) * S + s] = v;
    }
  };
  fetch((nc - 1) * K);
  hfetch(nc - 1);
  stage();
  __syncwarp();
  float carry[NJ], da[NJ], dyu = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    carry[j] = (dh_final != nullptr && d_ok && st[j] < S)
                   ? dh_final[((int64_t)b * D + d) * S + st[j]] : 0.f;
    da[j] = 0.f;
  }
  const int qs = MAXS * (c >> 2) + 4 * ls + p;    // what the lane sums of dB, dC
  const bool keeps_dc = c >= 4, keeps_ddt = ls >= 2;
  float* outw = &sm.out[w][0][0][0];
#pragma unroll 1
  for (int cc = nc - 1, n = 0; cc >= 0; --cc, ++n) {
    const int t0 = cc * K;
    uint4 hstart[2] = {hq[0], hq[1]};
    if (cc > 0) {
      fetch(t0 - K);
      hfetch(cc - 1);
    }
    float* redw = &sm.red[n % NRED][w][0][0];
    // one step of the walk: step k from its operands x = {dt, dt u, u, dy},
    // B and C, ā_k and the states before and after it
    auto walk_step = [&](int k, const float (&abk)[NJ], const float (&hprev)[NJ],
                         const float (&hcur)[NJ], const float4& x, const float4& bv,
                         const float4& cv) {
      const float bj[NJ] = {bv.x, bv.y, bv.z, bv.w};
      const float cj[NJ] = {cv.x, cv.y, cv.z, cv.w};
      float g[NJ], sgb = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = fmaf(x.w, cj[j], carry[j]);
        const float q = g[j] * (abk[j] * hprev[j]);
        sgb = fmaf(g[j], bj[j], sgb);
        sq = fmaf(a[j], q, sq);
        da[j] = fmaf(x.x, q, da[j]);
        carry[j] = abk[j] * g[j];
      }
      // dB, dC over the warp's channels. Round 1 pairs c with c ^ 2 (lane ^
      // 8): registers 0, 1 of one hold the states of registers 2, 3 of the
      // other; round 2 pairs c with c ^ 1 (lane ^ 4) likewise for registers
      // 0 and 1; round 3 pairs c with c ^ 4 (lane ^ 16), which hold the same
      // state: c < 4 keeps dB, c >= 4 dC
      const float sb2 = __shfl_xor_sync(FULL, g[2] * x.y, 8);
      const float sb3 = __shfl_xor_sync(FULL, g[3] * x.y, 8);
      const float sc2 = __shfl_xor_sync(FULL, x.w * hcur[2], 8);
      const float sc3 = __shfl_xor_sync(FULL, x.w * hcur[3], 8);
      float rb = fmaf(g[0], x.y, sb2), rc = fmaf(x.w, hcur[0], sc2);
      const float rb1 = fmaf(g[1], x.y, sb3), rc1 = fmaf(x.w, hcur[1], sc3);
      rb += __shfl_xor_sync(FULL, rb1, 4);
      rc += __shfl_xor_sync(FULL, rc1, 4);
      redw[k * 2 * MAXS + qs] = (keeps_dc ? rc : rb)
                                + __shfl_xor_sync(FULL, keeps_dc ? rb : rc, 16);
      // du, ddt over the channel's lanes: ls ^ 2 splits them (ls < 2 keep
      // du), ls ^ 1 completes both
      const float dup = x.x * sgb, ddtp = fmaf(x.z, sgb, sq);
      float v = (keeps_ddt ? ddtp : dup)
                + __shfl_xor_sync(FULL, keeps_ddt ? dup : ddtp, 2);
      v += __shfl_xor_sync(FULL, v, 1);
      v = fmaf(dskm, x.w, v);
      if (!(ls & 1)) outw[(k * 2 + (ls >> 1)) * CPW + c] = v;
      dyu = fmaf(x.w, x.z, dyu);
    };
    auto ld_x = [&](int k) { return ww.ud[k][c ^ (k & 3)]; };
    auto ld_x2 = [&](int k) {
      return *reinterpret_cast<const float2*>(&ww.ud[k][c ^ (k & 3)]);
    };
    auto ld_b = [&](int k) {
      return *reinterpret_cast<const float4*>(&ww.bc[k][p * MAXS + NJ * ls]);
    };
    auto ld_c = [&](int k) {
      return *reinterpret_cast<const float4*>(&ww.bc[k][4 * MAXS + p * MAXS + NJ * ls]);
    };
    // the states and ā of a half, recomputed from its checkpoint; a step of
    // the later half's walk and one of the earlier half's recompute go
    // together, and every shared operand is loaded a step before its use,
    // ahead of the step's shared stores
    float hs1[H + 1][NJ], ab1[H][NJ], hs0[H + 1][NJ], ab0[H][NJ];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* h0 = hf ? hs1[0] : hs0[0];
      const float4 r = xor_perm(__uint_as_float(hstart[hf].x), __uint_as_float(hstart[hf].y),
                                __uint_as_float(hstart[hf].z), __uint_as_float(hstart[hf].w), p);
      h0[0] = r.x;
      h0[1] = r.y;
      h0[2] = r.z;
      h0[3] = r.w;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float2 x = ld_x2(H + i);
      const float4 bv = ld_b(H + i);
      const float bj[NJ] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ab1[i][j] = ex2_mufu(x.x * a2[j]);
        hs1[i + 1][j] = fmaf(ab1[i][j], hs1[i][j], x.y * bj[j]);
      }
    }
    float4 xn = ld_x(K - 1), bn = ld_b(K - 1), cn = ld_c(K - 1);
    float2 rxn = ld_x2(0);
    float4 rbn = ld_b(0);
#pragma unroll
    for (int i = H - 1; i >= 0; --i) {
      const int k = H + i, jr = H - 1 - i;     // walk step k, recompute step jr
      const float4 x = xn, bv = bn, cv = cn;
      const float2 rx = rxn;
      const float4 rbv = rbn;
      xn = ld_x(k - 1);
      bn = ld_b(k - 1);
      cn = ld_c(k - 1);
      if (jr + 1 < H) {
        rxn = ld_x2(jr + 1);
        rbn = ld_b(jr + 1);
      }
      const float rbj[NJ] = {rbv.x, rbv.y, rbv.z, rbv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        ab0[jr][j] = ex2_mufu(rx.x * a2[j]);
        hs0[jr + 1][j] = fmaf(ab0[jr][j], hs0[jr][j], rx.y * rbj[j]);
      }
      walk_step(k, ab1[i], hs1[i], hs1[i + 1], x, bv, cv);
    }
#pragma unroll
    for (int i = H - 1; i >= 0; --i) {
      const float4 x = xn, bv = bn, cv = cn;
      if (i > 0) {
        xn = ld_x(i - 1);
        bn = ld_b(i - 1);
        cn = ld_c(i - 1);
      }
      walk_step(i, ab0[i], hs0[i], hs0[i + 1], x, bv, cv);
    }
    __syncwarp();
    {  // du, ddt of the chunk: lane (step kl, quantity hl), 8 channels
      const float* row = outw + (kl * 2 + hl) * CPW;
      In* dst = (hl ? ddt : du) + (bT + t0 + kl) * D + dw;
      const bool ok = t0 + kl < T;
      store4<In, VEC>(dst, row, ok && (!VEC || dw < D), D - dw);
      store4<In, VEC>(dst + 4, row + 4, ok && (!VEC || dw + 4 < D), D - dw - 4);
    }
    if (cc > 0) stage();
    __syncwarp();
    // the previous chunk's dB, dC, then this chunk's red released: a
    // thread's arrival for chunk n follows its reads of chunk n - 1
    if (n > 0) block_sum((n - 1) % NRED, ((n - 1) / NRED) & 1, t0 + K);
    mbar_arrive(&sm.bar[n % NRED]);
  }
  block_sum((nc - 1) % NRED, ((nc - 1) / NRED) & 1, 0);

#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (d_ok && st[j] < S) part_da[((int64_t)b * D + d) * S + st[j]] = da[j];
  if (d_ok && ls == 0) part_dd[(int64_t)b * D + d] = dyu;
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

template <typename In, bool VEC>
int launch_main(const void* u, const void* dt, const void* b_in, const void* c_in,
                const void* a_log, const void* d_skip, const float* dy,
                const float* dh, void* du, void* ddt, const float* ck, float* part_bc,
                float* part_da, float* part_dd, int B, int T, int D, int S,
                bool param_bf16, cudaStream_t st) {
  auto kern = ssm_scan_bwd_kernel<In, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((D + CB - 1) / CB, B), THREADS, sizeof(Smem), st>>>(
      static_cast<const In*>(u), static_cast<const In*>(dt),
      static_cast<const In*>(b_in), static_cast<const In*>(c_in), a_log, d_skip,
      dy, dh, static_cast<In*>(du), static_cast<In*>(ddt), ck, part_bc,
      part_da, part_dd, B, T, D, S, param_bf16);
  return (int)cudaGetLastError();
}

template <typename In>
int launch(const void* u, const void* dt, const void* b_in, const void* c_in,
           const void* a_log, const void* d_skip, const float* dy,
           const float* dh, void* du, void* ddt, void* db, void* dc,
           void* da_log, void* dd, const float* ck, float* part_bc, float* part_da,
           float* part_dd, int B, int T, int D, int S, bool param_bf16,
           cudaStream_t st) {
  const int err = D % 4 == 0
      ? launch_main<In, true>(u, dt, b_in, c_in, a_log, d_skip, dy, dh, du, ddt,
                              ck, part_bc, part_da, part_dd, B, T, D, S,
                              param_bf16, st)
      : launch_main<In, false>(u, dt, b_in, c_in, a_log, d_skip, dy, dh, du, ddt,
                               ck, part_bc, part_da, part_dd, B, T, D, S,
                               param_bf16, st);
  if (err) return err;
  const int nblk = (D + CB - 1) / CB;
  const int64_t total = 2 * (int64_t)B * T * S + (int64_t)D * S + D;
  const int64_t want = (total + RED_THREADS - 1) / RED_THREADS;
  const int blocks = (int)(want < 65535 ? want : 65535);
  ssm_scan_bwd_reduce_kernel<In><<<blocks, RED_THREADS, 0, st>>>(
      part_bc, part_da, part_dd, a_log, static_cast<In*>(db),
      static_cast<In*>(dc), da_log, dd, B, T, D, S, nblk, param_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan the caller passes (kernels/ssm_scan_bwd.py::plan):
// grid_x = ceil(D / 64) blocks along D (times B rows), `threads` threads and
// `smem_bytes` dynamic shared memory a block; a plan that does not match
// this source is refused. ck holds h after every 8th step that a step
// follows, floor((T - 1) / 8) * B * D * 16 floats, as the forward kernel
// (csrc/ssm_scan.cu) writes them under grad. Scratch sizes, in floats, that
// the caller allocates: part_bc 2 * grid_x * B * T * S; part_da B * D * S;
// part_dd B * D. dh may be null (a zero cotangent).
// in_bf16: 1 if u, dt, B, C (and du, ddt, dB, dC) are bfloat16, 0 if float32;
// param_bf16 the same for a_log, d_skip (and da_log, dD). Requires B, T,
// D >= 1 and 1 <= S <= 16 (checked by the Python wrapper). Returns the first
// CUDA error of the two launches, or 0.
extern "C" int ssm_scan_bwd_launch(
    const void* u, const void* dt, const void* b_in, const void* c_in,
    const void* a_log, const void* d_skip, const void* dy, const void* dh,
    void* du, void* ddt, void* db, void* dc, void* da_log, void* dd, const void* ck,
    void* part_bc, void* part_da, void* part_dd, int B, int T, int D, int S,
    int in_bf16, int param_bf16, int grid_x, int threads, int smem_bytes,
    void* stream) {
  if (S < 1 || S > MAXS || grid_x != (D + CB - 1) / CB || threads != THREADS ||
      smem_bytes != (int)sizeof(Smem))
    return (int)cudaErrorInvalidValue;
  const float* dyf = static_cast<const float*>(dy);
  const float* dhf = static_cast<const float*>(dh);
  const float* ckf = static_cast<const float*>(ck);
  float *pbc = static_cast<float*>(part_bc),
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

// Blocks of the main kernel one SM holds (its registers and shared memory),
// for in_bf16 and vec (D a multiple of 4) as above, into *blocks.
extern "C" int ssm_scan_bwd_blocks_per_sm(int in_bf16, int vec, int* blocks) {
  const void* kern =
      in_bf16 ? (vec ? (const void*)ssm_scan_bwd_kernel<__nv_bfloat16, true>
                     : (const void*)ssm_scan_bwd_kernel<__nv_bfloat16, false>)
              : (vec ? (const void*)ssm_scan_bwd_kernel<float, true>
                     : (const void*)ssm_scan_bwd_kernel<float, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, THREADS,
                                                            sizeof(Smem));
}
