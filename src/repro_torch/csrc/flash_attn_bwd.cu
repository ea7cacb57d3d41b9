// Causal GQA flash attention, backward: dq, dk, dv of o = softmax(q k^T *
// scale + mask) v, from the forward's o and its row log-sum-exp lse.
//
// No TPU kernel is replaced: the Pallas kernel (src/repro/kernels/
// flash_attn.py) is forward only, and the JAX models train through
// layers.flash_attention_lax, which JAX differentiates. This kernel is the
// backward of the port's forward kernel (flash_attn_fwd.cu, which writes
// lse), wrapped with it in one autograd Function (kernels/ops.py). Layouts
// are the forward's: q (B,T,H,dh), k (B,T,KV,dh), v (B,T,KV,dv), o and do
// (B,T,H,dv), lse (B,H,T) f32; query head h reads kv head h / (H/KV).
// Outputs dq (B,T,H,dh), dk (B,T,KV,dh), dv (B,T,KV,dv) in the inputs'
// dtype, accumulated in f32:
//   D = rowsum(dO o O)      P = exp(S * scale - lse), 0 where masked
//   dV = P^T dO             dP = dO V^T      dS = P o (dP - D)
//   dQ = dS K * scale       dK = dS^T Q * scale
// The mask is the forward's: key k is live for query q when k < T, k <= q
// (causal) and q - k < window (window > 0). P is rounded to bf16 before
// P^T dO and dS before its two products (bf16 path), as
// kernels.ref.attention_bwd_ref does.
//
// Three kernels, each run deterministically (no atomics: two runs give the
// same bits):
//   1. flash_bwd_dot_kernel: D, one warp per (b, t, h) row, f32 (B, H, T).
//   2. flash_bwd_dkdv_kernel: one block per (key tile, kv head, batch),
//      looping over the H/KV query heads of its kv head and every query
//      tile that can see the key tile (rows k0 .. k_last + window - 1, from
//      k0 when causal). dK and dV stay in registers across the loop, so the
//      sum over the group is a sum in registers.
//   3. flash_bwd_dq_kernel: one block per (query tile, head, batch),
//      looping over the key tiles its rows can see.
// Kernels 2 and 3 both recompute S and dP: 7 products where 5 would do,
// in exchange for no atomics and no f32 dQ buffer.
//
// What bounds it: operations. At chatglm3-6b's training shape (B=4,
// T=2048, H=32, KV=2, dh=128, causal) the backward's five products are 2.5x
// the forward's 1.374e11 FLOP, 3.44e11 FLOP, 0.347 ms at the H100's 989
// TFLOP/s bf16 rate. This first design is simple, not fast:
//   bf16 (dh == dv in {16, 32, 64, 128}): warp-level mma.sync m16n8k16
//   (bf16 in, f32 accumulate), operands through ldmatrix from padded
//   shared-memory tiles (row stride dh + 8 elements: the 8 rows of an
//   ldmatrix fall in 8 different 16-byte bank groups). Two warps per block,
//   each 16 rows of the block's 32: in kernel 2 the rows are keys, so S^T
//   = K Q^T and dP^T = V dO^T are computed directly with keys as rows and
//   P^T and dS^T become the A operands of dV and dK in registers, as they
//   come out of the accumulators; in kernel 3 the rows are queries and dS
//   is the A operand of dQ. Tiles are loaded with 16-byte loads, no
//   pipelining. No wgmma or TMA (a later redesign).
//   f32 (dh, dv <= 128; only the small f32 references reach it): blocks of
//   256 threads over 16 x 16 tiles with FP32 FMAs, exp by expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ bool live(int qpos, int kpos, int T_len, int causal, int window) {
  return qpos < T_len && kpos < T_len && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o O)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                     float* __restrict__ dsum, int rows, int T_len, int H,
                                     int dv) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;   // (b * T + t) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + (int64_t)row * dv;
  const T* drow = dout + (int64_t)row * dv;
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bt = row / H;
    dsum[((int64_t)(bt / T_len) * H + h) * T_len + bt % T_len] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
constexpr int ROWS = 32;          // rows of a tile (keys in kernel 2, queries in 3)
constexpr int MMA_THREADS = 64;   // two warps of 16 rows each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// which lands in r[i].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts, lane = 4g + t: an m16n8 accumulator holds (row g, cols
// 2t, 2t+1) in c[0..1] and (row g + 8, same cols) in c[2..3]; the A operand
// of a k16 step holds (row g | g + 8, cols 2t, 2t+1 | 2t + 8, 2t + 9), so
// the accumulators of two neighbouring n8 tiles are one A operand.
//
// A operand: 16 rows from r0, 16 columns from c0 of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldsm_x4(a, tile + (r0 + lane % 16) * LD + c0 + (lane / 16) * 8);
}
// B operands of two n8 tiles (n0, n0 + 8) at k16 step k0, for B[k][n] stored
// as tile[n][k] (K^T and V^T from K and V): r = {b0, b1} of each tile.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[4], const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  const int i = lane / 8;
  ldsm_x4(r, tile + (n0 + (i / 2) * 8 + lane % 8) * LD + k0 + (i % 2) * 8);
}
// The same for B[k][n] stored as tile[k][n] (Q, dO and K as the right-hand
// side of dK, dV and dQ).
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[4], const __nv_bfloat16* tile, int n0,
                                          int k0, int lane) {
  const int i = lane / 8;
  ldsm_x4_t(r, tile + (k0 + (i % 2) * 8 + lane % 8) * LD + n0 + (i / 2) * 8);
}

// ROWS rows of one head from (B, T, heads, D) at t0 into a tile of row
// stride LD; rows past T are zeros.
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* src, int b,
                                          int t0, int heads, int head, int T_len) {
  constexpr int VPR = D / 8;                       // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += MMA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len)
      val = *reinterpret_cast<const uint4*>(src + (((int64_t)b * T_len + t) * heads + head) * D + c);
    *reinterpret_cast<uint4*>(tile + r * LD + c) = val;
  }
}

// S-like products of this warp's 16 rows of `a_tile` against the 32 rows of
// `b_tile` (each D wide): acc (16 x 32, four n8 tiles) = A B^T.
template <int D, int LD>
__device__ __forceinline__ void rows_by_rows(float (&acc)[4][4], const __nv_bfloat16* a_tile,
                                             const __nv_bfloat16* b_tile, int r0, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, a_tile, r0, kk * 16, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bb[4];
      load_b_nk<LD>(bb, b_tile, np * 16, kk * 16, lane);
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// out (16 x D) += X (16 x 32, this warp's accumulators, rounded to bf16) *
// tile (32 x D, row-major).
template <int D, int LD>
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4], const float (&x)[4][4],
                                               const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a[4] = {pack_bf16x2(x[2 * ks][0], x[2 * ks][1]),
                           pack_bf16x2(x[2 * ks][2], x[2 * ks][3]),
                           pack_bf16x2(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                           pack_bf16x2(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bb[4];
      load_b_kn<LD>(bb, tile, np * 16, ks * 16, lane);
      mma(out[2 * np], a, bb[0], bb[1]);
      mma(out[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// A warp's 16 x D f32 accumulator times `scale`, to bf16 rows (b, t, head)
// of a (B, T, heads, D) tensor; rows past T are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[D / 8][4],
                                           float scale, int b, int t_r0, int heads, int head,
                                           int T_len, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t_r0 + lane / 4 + 8 * half;
    if (t >= T_len) continue;
    __nv_bfloat16* row = dst + (((int64_t)b * T_len + t) * heads + head) * D + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16x2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
  }
}

struct Args {
  int T_len, H, KV, causal, window;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Args p) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[ROWS * LD], vs[ROWS * LD], qs[ROWS * LD],
      dos[ROWS * LD];
  __shared__ float lse2[ROWS], dd[ROWS];          // lse * log2 e and D of the query tile
  const int k0 = blockIdx.x * ROWS;               // key tile 0 (the most causal work) first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = p.H / p.KV;
  const float sl2 = p.scale * LOG2E;
  load_rows<D, LD>(ks, k, b, k0, p.KV, kvh, p.T_len);
  load_rows<D, LD>(vs, v, b, k0, p.KV, kvh, p.T_len);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // query rows that can see a key of this tile
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.T_len - 1, k0 + ROWS - 1 + p.window - 1) : p.T_len - 1;
  const int key0 = k0 + 16 * warp + lane / 4;     // this thread's keys: key0, key0 + 8
  for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
    const float* lse_h = lse + ((int64_t)b * p.H + h) * p.T_len;
    const float* dd_h = dsum + ((int64_t)b * p.H + h) * p.T_len;
    for (int q0 = q_lo - q_lo % ROWS; q0 <= q_hi; q0 += ROWS) {
      __syncthreads();                            // the previous tile is consumed
      load_rows<D, LD>(qs, q, b, q0, p.H, h, p.T_len);
      load_rows<D, LD>(dos, dout, b, q0, p.H, h, p.T_len);
      if (threadIdx.x < ROWS) {
        const int t = q0 + threadIdx.x;
        lse2[threadIdx.x] = t < p.T_len ? lse_h[t] * LOG2E : 0.f;
        dd[threadIdx.x] = t < p.T_len ? dd_h[t] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];                    // S^T and dP^T: 16 keys x 32 queries
      rows_by_rows<D, LD>(s, ks, qs, 16 * warp, lane);
      rows_by_rows<D, LD>(dp, vs, dos, 16 * warp, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * (lane % 4) + (e & 1);
          const float pr = live(q0 + qi, key0 + 8 * (e / 2), p.T_len, p.causal, p.window)
                               ? exp2f(s[n][e] * sl2 - lse2[qi]) : 0.f;
          s[n][e] = pr;
          dp[n][e] = pr * (dp[n][e] - dd[qi]);
        }
      acc_times_rows<D, LD>(dv_acc, s, dos, lane);    // dV += P^T dO
      acc_times_rows<D, LD>(dk_acc, dp, qs, lane);    // dK += dS^T Q
    }
  }
  store_rows<D>(dk, dk_acc, p.scale, b, k0 + 16 * warp, p.KV, kvh, p.T_len, lane);
  store_rows<D>(dv, dv_acc, 1.f, b, k0 + 16 * warp, p.KV, kvh, p.T_len, lane);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, Args p) {
  constexpr int LD = D + 8;
  __shared__ __align__(16) __nv_bfloat16 qs[ROWS * LD], dos[ROWS * LD], ks[ROWS * LD],
      vs[ROWS * LD];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // the last query tile (most causal work) first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float sl2 = p.scale * LOG2E;
  load_rows<D, LD>(qs, q, b, q0, p.H, h, p.T_len);
  load_rows<D, LD>(dos, dout, b, q0, p.H, h, p.T_len);
  const int row0 = q0 + 16 * warp + lane / 4;     // this thread's rows: row0, row0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const int64_t at = ((int64_t)b * p.H + h) * p.T_len + t;
    lse2[r] = t < p.T_len ? lse[at] * LOG2E : 0.f;
    dd[r] = t < p.T_len ? dsum[at] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  // key rows that rows q0 .. q0 + ROWS - 1 can see
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(q0 + ROWS - 1, p.T_len - 1) : p.T_len - 1;
  for (int kb = k_lo - k_lo % ROWS; kb <= k_hi; kb += ROWS) {
    __syncthreads();                              // Q, dO stored; the previous K, V consumed
    load_rows<D, LD>(ks, k, b, kb, p.KV, kvh, p.T_len);
    load_rows<D, LD>(vs, v, b, kb, p.KV, kvh, p.T_len);
    __syncthreads();

    float s[4][4], dp[4][4];                      // S and dP: 16 queries x 32 keys
    rows_by_rows<D, LD>(s, qs, ks, 16 * warp, lane);
    rows_by_rows<D, LD>(dp, dos, vs, 16 * warp, lane);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int kpos = kb + 8 * n + 2 * (lane % 4) + (e & 1);
        const float pr = live(row0 + 8 * r, kpos, p.T_len, p.causal, p.window)
                             ? exp2f(s[n][e] * sl2 - lse2[r]) : 0.f;
        dp[n][e] = pr * (dp[n][e] - dd[r]);
      }
    acc_times_rows<D, LD>(dq_acc, dp, ks, lane);      // dQ += dS K
  }
  store_rows<D>(dq, dq_acc, p.scale, b, q0 + 16 * warp, p.H, h, p.T_len, lane);
}

// ---------------------------------------------------------------------------
// f32: FMA, 16 x 16 tiles, 256 threads
// ---------------------------------------------------------------------------
constexpr int FT = 16;            // tile rows
constexpr int F_THREADS = 256;    // one per (row, column) of a 16 x 16 tile
constexpr int MAXD = 128;
constexpr int PER = MAXD / 16;    // output columns per thread

// FT rows of one head from (B, T, heads, d) at t0 into tile[FT][d + 1].
__device__ __forceinline__ void load_rows_f32(float* tile, const float* src, int b, int t0,
                                              int heads, int head, int d, int T_len) {
  for (int i = threadIdx.x; i < FT * d; i += F_THREADS) {
    const int r = i / d, c = i - r * d, t = t0 + r;
    tile[r * (d + 1) + c] = t < T_len ? src[(((int64_t)b * T_len + t) * heads + head) * d + c] : 0.f;
  }
}

__device__ __forceinline__ float dot_rows(const float* x, const float* y, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(x[c], y[c], acc);
  return acc;
}

// Shared memory of either f32 kernel: four FT x (d + 1) tiles, P and dS.
__host__ __device__ inline size_t f32_smem(int dh, int dv) {
  return sizeof(float) * (2 * (size_t)FT * (dh + 1) + 2 * (size_t)FT * (dv + 1) + 2 * FT * (FT + 1) +
                          2 * FT);
}

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          float* __restrict__ dk, float* __restrict__ dv, Args p, int dh,
                          int dvd) {
  extern __shared__ float sm[];
  float* ks = sm;                                 // FT x (dh + 1)
  float* qs = ks + FT * (dh + 1);
  float* vs = qs + FT * (dh + 1);                 // FT x (dvd + 1)
  float* dos = vs + FT * (dvd + 1);
  float* ps = dos + FT * (dvd + 1);               // FT x (FT + 1): [key][query]
  float* dss = ps + FT * (FT + 1);
  float* lse_s = dss + FT * (FT + 1);
  float* dd = lse_s + FT;
  const int k0 = blockIdx.x * FT, kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.KV;
  const int kr = threadIdx.x / FT, c = threadIdx.x % FT;   // key row; query column or d
  load_rows_f32(ks, k, b, k0, p.KV, kvh, dh, p.T_len);
  load_rows_f32(vs, v, b, k0, p.KV, kvh, dvd, p.T_len);
  float dk_acc[PER], dv_acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.T_len - 1, k0 + FT - 1 + p.window - 1) : p.T_len - 1;
  for (int h = kvh * g; h < (kvh + 1) * g; ++h) {
    for (int q0 = q_lo - q_lo % FT; q0 <= q_hi; q0 += FT) {
      __syncthreads();
      load_rows_f32(qs, q, b, q0, p.H, h, dh, p.T_len);
      load_rows_f32(dos, dout, b, q0, p.H, h, dvd, p.T_len);
      if (threadIdx.x < FT) {
        const int t = q0 + threadIdx.x;
        const int64_t at = ((int64_t)b * p.H + h) * p.T_len + t;
        lse_s[threadIdx.x] = t < p.T_len ? lse[at] : 0.f;
        dd[threadIdx.x] = t < p.T_len ? dsum[at] : 0.f;
      }
      __syncthreads();
      {
        const float s = dot_rows(ks + kr * (dh + 1), qs + c * (dh + 1), dh) * p.scale;
        const float dpv = dot_rows(vs + kr * (dvd + 1), dos + c * (dvd + 1), dvd);
        const float pr = live(q0 + c, k0 + kr, p.T_len, p.causal, p.window)
                             ? expf(s - lse_s[c]) : 0.f;
        ps[kr * (FT + 1) + c] = pr;
        dss[kr * (FT + 1) + c] = pr * (dpv - dd[c]);
      }
      __syncthreads();
      for (int qc = 0; qc < FT; ++qc) {
        const float pr = ps[kr * (FT + 1) + qc], ds = dss[kr * (FT + 1) + qc];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int d = c + FT * j;
          if (d < dvd) dv_acc[j] = fmaf(pr, dos[qc * (dvd + 1) + d], dv_acc[j]);
          if (d < dh) dk_acc[j] = fmaf(ds, qs[qc * (dh + 1) + d], dk_acc[j]);
        }
      }
    }
  }
  const int t = k0 + kr;
  if (t >= p.T_len) return;
  const int64_t row = ((int64_t)b * p.T_len + t) * p.KV + kvh;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = c + FT * j;
    if (d < dh) dk[row * dh + d] = dk_acc[j] * p.scale;
    if (d < dvd) dv[row * dvd + d] = dv_acc[j];
  }
}

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dsum,
                        float* __restrict__ dq, Args p, int dh, int dvd) {
  extern __shared__ float sm[];
  float* qs = sm;                                 // FT x (dh + 1)
  float* ks = qs + FT * (dh + 1);
  float* dos = ks + FT * (dh + 1);                // FT x (dvd + 1)
  float* vs = dos + FT * (dvd + 1);
  float* dss = vs + FT * (dvd + 1);               // FT x (FT + 1): [query][key]
  float* lse_s = dss + 2 * FT * (FT + 1);
  float* dd = lse_s + FT;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int qr = threadIdx.x / FT, c = threadIdx.x % FT;   // query row; key column or d
  load_rows_f32(qs, q, b, q0, p.H, h, dh, p.T_len);
  load_rows_f32(dos, dout, b, q0, p.H, h, dvd, p.T_len);
  if (threadIdx.x < FT) {
    const int t = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * p.H + h) * p.T_len + t;
    lse_s[threadIdx.x] = t < p.T_len ? lse[at] : 0.f;
    dd[threadIdx.x] = t < p.T_len ? dsum[at] : 0.f;
  }
  float dq_acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) dq_acc[j] = 0.f;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(q0 + FT - 1, p.T_len - 1) : p.T_len - 1;
  for (int kb = k_lo - k_lo % FT; kb <= k_hi; kb += FT) {
    __syncthreads();
    load_rows_f32(ks, k, b, kb, p.KV, kvh, dh, p.T_len);
    load_rows_f32(vs, v, b, kb, p.KV, kvh, dvd, p.T_len);
    __syncthreads();
    {
      const float s = dot_rows(qs + qr * (dh + 1), ks + c * (dh + 1), dh) * p.scale;
      const float dpv = dot_rows(dos + qr * (dvd + 1), vs + c * (dvd + 1), dvd);
      const float pr = live(q0 + qr, kb + c, p.T_len, p.causal, p.window)
                           ? expf(s - lse_s[qr]) : 0.f;
      dss[qr * (FT + 1) + c] = pr * (dpv - dd[qr]);
    }
    __syncthreads();
    for (int kc = 0; kc < FT; ++kc) {
      const float ds = dss[qr * (FT + 1) + kc];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int d = c + FT * j;
        if (d < dh) dq_acc[j] = fmaf(ds, ks[kc * (dh + 1) + d], dq_acc[j]);
      }
    }
  }
  const int t = q0 + qr;
  if (t >= p.T_len) return;
  const int64_t row = ((int64_t)b * p.T_len + t) * p.H + h;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = c + FT * j;
    if (d < dh) dq[row * dh + d] = dq_acc[j] * p.scale;
  }
}

template <typename T>
int launch_dot(const void* o, const void* dout, float* dsum, int B, int T_len, int H, int dv,
               cudaStream_t st) {
  const int rows = B * T_len * H;
  constexpr int WARPS = 8;
  flash_bwd_dot_kernel<T><<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, rows, T_len, H, dv);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dsum, void* dq, void* dk, void* dv, int B, const Args& p,
               cudaStream_t st) {
  using bf = __nv_bfloat16;
  const int tiles = (p.T_len + ROWS - 1) / ROWS;
  flash_bwd_dkdv_kernel<D><<<dim3(tiles, p.KV, B), MMA_THREADS, 0, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, dsum, static_cast<bf*>(dk), static_cast<bf*>(dv), p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq_kernel<D><<<dim3(tiles, p.H, B), MMA_THREADS, 0, st>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), lse, dsum, static_cast<bf*>(dq), p);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dsum, void* dq, void* dk, void* dv, int B, const Args& p, int dh,
               int dvd, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {           // the largest tile set (dh = dv = MAXD) may pass 48 KB
    const int max_smem = (int)f32_smem(MAXD, MAXD);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const size_t smem = f32_smem(dh, dvd);
  const int tiles = (p.T_len + FT - 1) / FT;
  flash_bwd_dkdv_f32_kernel<<<dim3(tiles, p.KV, B), F_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), p, dh, dvd);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dq_f32_kernel<<<dim3(tiles, p.H, B), F_THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, dsum, static_cast<float*>(dq), p, dh, dvd);
  return (int)cudaGetLastError();
}

}  // namespace

// Runs the three kernels on `stream`. is_bf16: 1 for bfloat16 tensors, 0 for
// float32; window <= 0 means none. dsum: (B, H, T) f32 scratch for D.
// Requires B, T_len >= 1 and H % KV == 0; f32: 1 <= dh, dv <= 128; bf16: dh
// == dv in {16, 32, 64, 128}, contiguous tensors with 16-byte aligned bases
// (all checked by the Python wrapper). Returns the first non-zero
// cudaGetLastError() of the launches, or 0.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* o, const float* lse, const void* dout,
                                     void* dq, void* dk, void* dv, float* dsum, int B,
                                     int T_len, int H, int KV, int dh, int dvd, float scale,
                                     int causal, int window, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args p{T_len, H, KV, causal, window, scale};
  int err = is_bf16 ? launch_dot<__nv_bfloat16>(o, dout, dsum, B, T_len, H, dvd, st)
                    : launch_dot<float>(o, dout, dsum, B, T_len, H, dvd, st);
  if (err) return err;
  if (!is_bf16) return launch_f32(q, k, v, dout, lse, dsum, dq, dk, dv, B, p, dh, dvd, st);
  if (dh != dvd) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 16: return launch_mma<16>(q, k, v, dout, lse, dsum, dq, dk, dv, B, p, st);
    case 32: return launch_mma<32>(q, k, v, dout, lse, dsum, dq, dk, dv, B, p, st);
    case 64: return launch_mma<64>(q, k, v, dout, lse, dsum, dq, dk, dv, B, p, st);
    case 128: return launch_mma<128>(q, k, v, dout, lse, dsum, dq, dk, dv, B, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
