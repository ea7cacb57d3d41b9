// Causal GQA flash attention, forward: o = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (_flash_kernel). Layouts are the reference's: q (B,T,H,dh), k (B,T,KV,dh),
// v (B,T,KV,dv), o (B,T,H,dv), all contiguous; query head h reads kv head
// h / (H/KV).
//
// Bound on an H100: operations. At T=2048, dh=dv=128 the function does
// ~2*T*(dh+dv)/2 ~ 260k operations per query row against ~1 KB of q/o bytes
// per row, far above the ~295 bf16 operations per byte where memory would
// be the limit; the bound is the tensor cores' bf16 rate.
//
// Structure shared by both paths below:
//   * One block per (q tile of 64 rows, head, batch). The Pallas kernel
//     carries m/l/acc across sequential kv grid steps in VMEM scratch; CUDA
//     blocks run in no order, so a loop inside the block walks the kv tiles
//     and keeps m, l and the accumulator in registers.
//   * The causal and window skips are the loop's bounds: kv tiles entirely
//     above the diagonal or older than the window are never visited (the
//     reference lax version computes and masks them).
//   * Ragged T is masked inside the kernel (loads past T read zeros, rows
//     past T are not stored), so the caller pads nothing.
// Two paths, chosen by dtype:
//   * mma path (bf16, dh == dv in {16, 32, 64, 128}; the model's prefill is
//     128): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//     accumulate). 4 warps, 16 query rows each; q fragments stay in
//     registers for the whole kv loop, k and v^T tiles are staged in padded
//     shared memory (conflict-free fragment loads), and P goes from the
//     score accumulators to the A operand of P.V in registers, rounded to
//     bf16 as the reference (layers.flash_attention_lax) rounds it to
//     v.dtype; l sums it unrounded. Single-buffered, no ldmatrix/TMA/wgmma:
//     those are later work.
//   * FMA path (f32, any dh, dv up to 128): the tiles are staged in shared
//     memory and each of 256 threads computes a 4x4 block of scores and a
//     4x8 block of the output with FP32 FMAs.
// Numerics (both): scores, m, l and the accumulator are f32; l is clamped at
// 1e-30 before the divide.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per kv tile
constexpr float NEG_INF = -1e30f;

// FMA path
constexpr int THREADS = 256;     // 16 x 16 thread grid
constexpr int MAXD = 128;        // largest dh / dv supported
constexpr int RPT = BQ / 16;     // query rows per thread
constexpr int CPT = BK / 16;     // score columns per thread
constexpr int OPT = MAXD / 16;   // output columns per thread

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T_len, int H,
                 int KV, int dh, int dv, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int ldq = dh + 1;                 // padded row stride of Qs / Ks
  const int ldp = BK + 1;
  float* Qs = smem;                       // BQ x ldq
  float* Ks = Qs + BQ * ldq;              // BK x ldq
  float* Vs = Ks + BK * ldq;              // BK x dv
  float* Ps = Vs + BK * dv;               // BQ x ldp

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;                // score / output column group
  const int ty = tid / 16;                // query row group

  for (int idx = tid; idx < BQ * dh; idx += THREADS) {
    const int r = idx / dh, d = idx - r * dh;
    const int t = q0 + r;
    Qs[r * ldq + d] = t < T_len ? q[(((int64_t)b * T_len + t) * H + h) * dh + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  // kv positions any row of this tile can see
  const int q_last = min(q0 + BQ, T_len) - 1;
  const int k_hi = causal ? q_last : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // previous tile fully consumed
    for (int idx = tid; idx < BK * dh; idx += THREADS) {
      const int r = idx / dh, d = idx - r * dh;
      const int t = k0 + r;
      Ks[r * ldq + d] = t < T_len ? k[(((int64_t)b * T_len + t) * KV + kvh) * dh + d] : 0.f;
    }
    for (int idx = tid; idx < BK * dv; idx += THREADS) {
      const int r = idx / dv, d = idx - r * dv;
      const int t = k0 + r;
      Vs[r * dv + d] = t < T_len ? v[(((int64_t)b * T_len + t) * KV + kvh) * dv + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rowmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool live = kpos < T_len;
        if (causal) live = live && kpos <= qpos;
        if (window > 0) live = live && (qpos - kpos) < window;
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
      // the 16 threads of one row are lanes with equal ty in one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_new = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * ldp + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int col = tx + 16 * j;
        vv[j] = col < dv ? Vs[c * dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + (((int64_t)b * T_len + t) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) orow[col] = acc[i][j] / denom;
    }
  }
}


// ---------------------------------------------------------------------------
// mma path: bf16, dh == dv == D in {16, 32, 64, 128}
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows
constexpr int PAD = 8;             // bf16 elements of row padding in smem

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts of mma.m16n8k16 (PTX ISA), with g = lane / 4, t = lane % 4:
//   A (16x16, row): regs {r g, k 2t..2t+1}, {r g+8, k 2t..}, {r g, k 2t+8..},
//                   {r g+8, k 2t+8..}
//   B (16x8, col):  regs {k 2t..2t+1, n g}, {k 2t+8..2t+9, n g}
//   C (16x8):       c0,c1 at (r g, n 2t..2t+1), c2,c3 at (r g+8, n 2t..2t+1)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int T_len, int H, int KV,
                     float scale, int causal, int window) {
  constexpr int LDK = D + PAD;    // Ks[key][d]
  constexpr int LDV = BK + PAD;   // Vt[d][key]
  constexpr int CH = D / 8;       // 16-byte chunks per k/v row
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + (tid / 32) * 16 + g;     // rows row0 and row0 + 8

  // q fragments for the whole head dim, loaded once from global memory
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = 16 * kk + 2 * t + (r >> 1) * 8;
      qf[kk][r] = row < T_len
          ? ld_bf16x2(q + (((int64_t)b * T_len + row) * H + h) * D + col) : 0u;
    }
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int q_last = min(q0 + BQ, T_len) - 1;
  const int k_hi = causal ? q_last : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                      // previous tile fully consumed
    // k rows: a quarter-warp stores 128 contiguous bytes of one row
    for (int idx = tid; idx < BK * CH; idx += MMA_THREADS) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const int tk = k0 + r;
      int4 val = make_int4(0, 0, 0, 0);
      if (tk < T_len)
        val = *reinterpret_cast<const int4*>(k + (((int64_t)b * T_len + tk) * KV + kvh) * D + c);
      *reinterpret_cast<int4*>(&Ks[r * LDK + c]) = val;
    }
    // v transposed: consecutive threads take consecutive keys, so the
    // scattered 2-byte stores of one warp fall in distinct banks
    for (int idx = tid; idx < BK * CH; idx += MMA_THREADS) {
      const int r = idx % BK, c = (idx / BK) * 8;
      const int tk = k0 + r;
      int4 val = make_int4(0, 0, 0, 0);
      if (tk < T_len)
        val = *reinterpret_cast<const int4*>(v + (((int64_t)b * T_len + tk) * KV + kvh) * D + c);
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LDV + r] = e8[i];
    }
    __syncthreads();

    // S = q k^T for this warp's 16 rows and the tile's BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kr = &Ks[(8 * j + g) * LDK + 16 * kk + 2 * t];
        const uint32_t bf[2] = {ld_bf16x2(kr), ld_bf16x2(kr + 8)};
        mma_bf16_16816(s[j], qf[kk], bf);
      }
    }

    // mask, online softmax; a row's 4 owners are lanes 4g..4g+3
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        bool live = key < T_len;
        if (causal) live = live && key <= row;
        if (window > 0) live = live && (row - key) < window;
        s[j][e] = live ? s[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P v: two adjacent score tiles form one A fragment (P in bf16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vr = &Vt[(8 * j + g) * LDV + 16 * kk + 2 * t];
        const uint32_t bf[2] = {ld_bf16x2(vr), ld_bf16x2(vr + 8)};
        mma_bf16_16816(acc[j], pa, bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + (((int64_t)b * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int T_len, int H, int KV, float scale, int causal, int window,
               cudaStream_t stream) {
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      T_len, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int T_len, int H, int KV, int dh, int dv, float scale, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * (dh + 1) + (size_t)BK * (dh + 1) + (size_t)BK * dv + (size_t)BQ * (BK + 1));
  static bool configured = false;
  if (!configured) {
    // largest tile set (dh = dv = MAXD); above 48 KB needs the opt-in
    const size_t max_smem = sizeof(float) *
        ((size_t)(BQ + BK) * (MAXD + 1) + (size_t)BK * MAXD + (size_t)BQ * (BK + 1));
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), T_len, H, KV, dh, dv, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. window <= 0 means none.
// Requires B, T_len >= 1 and H % KV == 0; f32: 1 <= dh, dv <= 128; bf16:
// dh == dv in {16, 32, 64, 128} and 16-byte aligned pointers (all checked by
// the Python wrapper). Returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     void* o, int B, int T_len, int H, int KV,
                                     int dh, int dv, float scale, int causal,
                                     int window, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_fma(q, k, v, o, B, T_len, H, KV, dh, dv, scale, causal, window, st);
  switch (dh) {
    case 16: return launch_mma<16>(q, k, v, o, B, T_len, H, KV, scale, causal, window, st);
    case 32: return launch_mma<32>(q, k, v, o, B, T_len, H, KV, scale, causal, window, st);
    case 64: return launch_mma<64>(q, k, v, o, B, T_len, H, KV, scale, causal, window, st);
    case 128: return launch_mma<128>(q, k, v, o, B, T_len, H, KV, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
