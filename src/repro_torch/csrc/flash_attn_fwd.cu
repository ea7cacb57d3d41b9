// Causal GQA flash attention, forward: o = softmax(q k^T * scale + mask) v.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py:104 (the
// pallas_call of flash_attention; body _flash_kernel, :28). Layouts are the
// reference's: q (B,T,H,dh), k (B,T,KV,dh), v (B,T,KV,dv), o (B,T,H,dv), all
// contiguous; query head h reads kv head h / (H/KV). causal, window and
// scale as the wrapper documents; any T (the ragged last tile is masked in
// the kernel, the caller pads nothing). m, l and the accumulator are f32, l
// is clamped at 1e-30 before the divide.
//
// The reference's two attention flags (layers.flash_attention_lax) are
// template arguments of both paths, so the instances with neither flag are
// the kernels as they were:
//   * scale_in_q: q is multiplied by the scale in f32 and rounded back to
//     its dtype before the product, which then takes no scale. The f32 path
//     scales Q as it stages it; the bf16 path's consumers scale their 64
//     rows of the Q tile in shared memory once per item, before its first
//     product.
//   * probs_bf16: the exp's argument s - m is rounded to bf16 in the natural
//     domain (the bf16 path keeps S and m in it for this instance and folds
//     log2 e into the exp2's argument after the rounding). P is not rounded
//     after the exp beyond what P V does anyway (bf16 path), and l sums it
//     as it comes: the reference rounds the exp's result to bf16 in its
//     source, but XLA folds that round trip away (its compiled program takes
//     the exp in f32 of the rounded argument), and ref.attention_ref and
//     this kernel follow what the reference computes.
//
// The row log-sum-exp, lse = m + ln l (B, H, T) f32, is written for the
// backward kernel (flash_attn_bwd.cu) by instances with the template
// argument LSE, launched only when it is asked for and only without the two
// flags; the instances without it are the kernels as they were.
//
// Two paths, chosen by dtype.
//
// bf16 (dh == dv in {16, 32, 64, 128}; the dense models' prefill is 128):
// a forward flash attention built for Hopper. What bounds it: operations.
// At the path's shape (B=4, T=2048, H=32, KV=2, dh=128, causal) it does
// 4*dh FLOP per causal (q, k) pair, 1.374e11 FLOP, 0.139 ms at the H100's
// 989 TFLOP/s bf16 rate, against 0.04 ms to move q, k, v and o once. So the
// design keeps the tensor cores fed and takes everything else off their way:
//   * wgmma, the only route to the full tensor-core rate: S = Q K^T is
//     wgmma m64n128k16 with Q and K read from shared memory through
//     descriptors (K lies [key][d], K-major for B, no transpose); O += P V is
//     wgmma with P as the A operand in registers (the S accumulators,
//     rounded to bf16 in place: the accumulator layout is the register-A
//     layout) and V as an MN-major B operand straight from its TMA tile,
//     so V is never transposed.
//   * Warp specialisation, 3 warpgroups per block: a producer warpgroup
//     whose one elected thread issues every load (and which gives its
//     registers up with setmaxnreg), and two consumer warpgroups of 64
//     query rows each, which take those registers (S, P and O of 64 x 128
//     stay in registers). A work item is 128 query rows of one head.
//   * TMA: one instruction per 64-column box copies a whole 128-row tile,
//     128-byte swizzled as wgmma reads it. The tensor maps are 4-D over the
//     tensors' own layout (d, head, t, batch), so the T bound zero-fills a
//     ragged last tile, no tile crosses into the next batch row, and the d
//     bound zero-fills the columns past dh when dh < 64 (dh 16 and 32 run
//     the dh 64 instance). O leaves the same way: written over the
//     warpgroup's Q rows in shared memory, stored by TMA, whose bounds
//     clip rows past T and columns past dv, so the epilogue has no branch.
//   * mbarrier rings of 2 stages for K and 2 for V, released separately
//     (full/empty barriers): K of tile i+1 loads while P V(i) still reads
//     V(i). Q has two buffers, so the next item's Q loads during this one.
//   * Overlap of softmax and products: each consumer issues S(i+1) before
//     P V(i) and runs the softmax of tile i+1 while P V(i) is in flight; the
//     two consumers take turns to issue (a ping-pong on named barriers), so
//     one's softmax also runs under the other's products.
//   * Online softmax in registers with exp2 (scale * log2 e folded in
//     once); a row's max is reduced across its 4 lanes per tile, its sum
//     once at the end. Only tiles that cross the diagonal, the window's
//     lower edge or T are masked, with selects; the loop bounds skip the
//     dead tiles. P is rounded to bf16 before P V, as
//     layers.flash_attention_lax and ref.attention_ref round it to v.dtype;
//     l sums it unrounded.
//   * Scheduling: a persistent grid of one block per SM. The producer takes
//     each next item from a counter in device memory, so a block that
//     finishes early takes more (no tail of idle SMs), and loads it while
//     the consumers finish the last one. Items come in the order of most
//     causal work first, and within a q tile the heads of one batch row
//     side by side, so the H/KV heads that share a kv head run together and
//     read the same K/V from L2.
// Shared memory at dh 128: Q 2 x 32 KB + 2 x K 32 KB + 2 x V 32 KB = 192 KB.
//
// f32 (any dh, dv up to 128; only the small f32 reference runs reach it):
// one block per (64-row q tile, head, batch), tiles staged in shared
// memory, each of 256 threads computes a 4x4 block of scores and a 4x8
// block of the output with FP32 FMAs.
#include <cuda.h>   // CUtensorMap and its enums; the encode call is looked up at run time
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool SCALE_Q, bool PROBS_BF16, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int T_len, int H,
                 int KV, int dh, int dv, float scale, int causal, int window,
                 float* __restrict__ lse) {
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
    const float x = t < T_len ? q[(((int64_t)b * T_len + t) * H + h) * dh + d] : 0.f;
    Qs[r * ldq + d] = SCALE_Q ? x * scale : x;
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
        s[i][j] = live ? (SCALE_Q ? s[i][j] : s[i][j] * scale) : NEG_INF;
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
        const float x = s[i][j] - m_new;
        const float p = expf(PROBS_BF16 ? round_bf16(x) : x);
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
    if (LSE && tx == 0) lse[((int64_t)b * H + h) * T_len + t] = m[i] + logf(l[i]);
    float* orow = o + (((int64_t)b * T_len + t) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < OPT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) orow[col] = acc[i][j] / denom;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 path: TMA + mbarrier ring + wgmma, one instance per D in {64, 128}
// ---------------------------------------------------------------------------
constexpr int TQ = 128;            // query rows per block (2 consumer warpgroups x 64)
constexpr int TK = 128;            // keys per kv tile
constexpr int STAGES = 2;          // K/V ring depth
constexpr int WG_THREADS = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;            // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int BOX_BYTES = TQ * BOX * 2;   // one 128-row box, 16 KB (TQ == TK)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Every tile is D / BOX boxes of [128 rows][64 columns], 128-byte swizzled.
template <int D>
struct Smem {
  __nv_bfloat16 q[2][D / BOX][TQ * BOX];      // this item's Q and the next one's
  __nv_bfloat16 k[STAGES][D / BOX][TK * BOX];
  __nv_bfloat16 v[STAGES][D / BOX][TK * BOX];
  uint64_t q_full[2], q_empty[2];
  uint64_t full_k[STAGES], empty_k[STAGES];   // K and V rings, released separately
  uint64_t full_v[STAGES], empty_v[STAGES];
  int item[2];                                // the item in each Q buffer, -1: none
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
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

// One box of a 4-D map at coordinates (d, head, t, batch) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int head, int t,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(head), "r"(t), "r"(batch)
      : "memory");
}

// One box from shared memory to a 4-D map at (d, head, t, batch); the map's
// bounds clip what lies outside the tensor.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int d,
                                          int head, int t, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(d), "r"(head),
         "r"(t), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every bulk store this thread committed has read its shared
// memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define ACC8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16, shared) * B (16 x 128, shared); both
// K-major. scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8

// Named barriers 1 and 2 order the two consumer warpgroups' turns to issue
// products (256 threads: both consumers).
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Named barriers 3 and 4: the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Kernel arguments besides the tensor maps.
struct Params {
  int* next_item;              // work counter, zero at launch
  int T_len, H, KV, B, n_qt, n_items, causal, window;
  float score_scale;           // S's factor: scale * log2 e (exp2 domain); 1 in
                               // place of scale with scale_in_q, no log2 e with
                               // probs_bf16 (natural domain)
  float q_scale;               // scale_in_q: Q's factor
  float* lse;                  // LSE instances: (B, H, T) f32
};

// Register layout of a wgmma m64nN accumulator, per warpgroup thread with
// w = warp (0..3), g = lane / 4, t = lane % 4: element 4j + e sits at row
// 16w + g + 8 * (e / 2), column 8j + 2t + e % 2. A register-A fragment for
// k16 holds rows 16w + g (+8) and columns 2t (+1), 2t + 8 (+1): two
// neighbouring 8-column accumulator groups, so S becomes P's A operand in
// place.
//
// One tile's online-softmax step on S (64 x 128 keys from k0), in place:
// sc becomes P = exp2(S * scale log2 e - m), m and l are updated and
// alpha is the factor that rescales the accumulator. With PROBS_BF16, S
// and m stay in the natural domain and P = exp2(bf16(S * scale - m) *
// log2 e). row0 and col0 are
// the thread's first row and column in the layout above. `edge` tiles
// (across the diagonal, the window's lower edge or T) are masked: key k is
// live for row r when r - window < k <= r (causal) and k < T, written as
// per-row bounds on the key's column in the tile, so the mask is selects,
// not branches.
template <bool PROBS_BF16>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Params& p, int row0, int col0,
                                             int k0, bool edge) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] *= p.score_scale;
  if (edge) {
    int lo[2], hi[2];                 // live columns lo..hi of the tile, per row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      hi[r] = min(p.causal ? row : p.T_len - 1, p.T_len - 1) - k0 - col0;
      lo[r] = p.window > 0 ? row - p.window + 1 - k0 - col0 : -TK;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = 8 * (i / 4) + (i % 2);   // minus the thread's col0
      const int r = (i % 4) / 2;
      sc[i] = (col >= lo[r]) & (col <= hi[r]) ? sc[i] : NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {       // a row's 4 owners are lanes 4g..4g+3
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(PROBS_BF16 ? (m[r] - mx[r]) * LOG2E : m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if constexpr (PROBS_BF16)
      sc[i] = fast_exp2(round_bf16(sc[i] - m[(i % 4) / 2]) * LOG2E);
    else
      sc[i] = fast_exp2(sc[i] - m[(i % 4) / 2]);
    l[(i % 4) / 2] += sc[i];          // unrounded P; reduced across lanes at the end
  }
  // Pin the results here: without this the compiler sinks all of the
  // arithmetic above below the next wgmma wait, and the softmax no longer
  // overlaps the products in flight.
  fence_regs(sc);
  fence_regs(l);
  fence_regs(alpha);
}

// P (rounded to bf16) as the A fragments of 8 k16 steps over the 128 keys.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[TK / 16][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// S = Q K^T for the warpgroup's 64 rows: D / 16 steps of k16; a step moves
// 32 bytes along the swizzled row, every 4 steps to the next 64-column box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q_addr + off, 16, 1024),
                  sw128_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V: V's tile is [key][d], MN-major for B. A k16 step is 16 keys,
// two groups of 8 rows 1024 B apart (SBO); the next 64 columns of d are
// the next box (LBO).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[TK / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    const uint64_t vd = sw128_desc(v_addr + kk * 16 * 128, BOX_BYTES, 1024);
    if constexpr (D == 128) wgmma_rs_n128(acc, pa[kk], vd);
    else wgmma_rs_n64(acc, pa[kk], vd);
  }
  wgmma_commit();
}

// A work item is one (128-row q tile, q head, batch row). Items are
// numbered with the q tiles of the most causal work first and, within a
// q tile, the heads of one batch row side by side (so the H/KV heads that
// share a kv head run at the same time and read the same K/V from L2).
struct Item {
  int b, h, q0, kt_hi, n_tiles;   // kv tiles kt_hi, kt_hi - 1, ..., walked in that order
};

__device__ __forceinline__ Item item_at(int w, const Params& p) {
  Item it;
  const int bh = w % (p.B * p.H);
  it.h = bh % p.H;
  it.b = bh / p.H;
  it.q0 = (p.n_qt - 1 - w / (p.B * p.H)) * TQ;
  const int q_last = min(it.q0 + TQ, p.T_len) - 1;
  it.kt_hi = (p.causal ? q_last : p.T_len - 1) / TK;
  const int kt_lo = p.window > 0 ? max(0, it.q0 - p.window + 1) / TK : 0;
  it.n_tiles = it.kt_hi - kt_lo + 1;
  return it;
}

// A consumer warpgroup: 64 query rows of each item against its kv tiles.
// S(i+1) is issued before P V(i), so the softmax of tile i+1 runs while
// the tensor cores compute P V(i). The two consumers take turns to issue
// (ping-pong on named barriers 1 and 2), so one's softmax also runs under
// the other's products instead of beside it. `g` counts kv tiles over all
// of the block's items and gives each tile's ring stage and phase.
// scale_in_q: q * scale in f32, rounded to bf16 (round to nearest even),
// over one consumer's 64 rows of each box of a Q tile in shared memory;
// the swizzle does not matter to an element-wise product.
template <int D>
__device__ __forceinline__ void scale_q_rows(uint8_t* rows, float scale) {
  for (int i = threadIdx.x % 128; i < (D / BOX) * 64 * 128 / 16; i += 128) {
    uint4* ptr = reinterpret_cast<uint4*>(rows + (i / 512) * BOX_BYTES + (i % 512) * 16);
    uint4 w = *ptr;
    uint32_t* words = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&words[j]));
      words[j] = pack_bf16x2(f.x * scale, f.y * scale);
    }
    *ptr = w;
  }
  // the products read Q through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int D, bool SCALE_Q, bool PROBS_BF16, bool LSE>
__device__ __forceinline__ void consumer(Smem<D>& sm, const CUtensorMap* map_o,
                                         const Params& p) {
  static_assert(!(LSE && PROBS_BF16), "the LSE is taken in the exp2 domain");
  const int c = threadIdx.x / 128 - 1;            // consumer warpgroup 0 or 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int my_turn = 1 + c, other_turn = 2 - c;
  if (c == 1) turn_pass(1);          // consumer 0 issues first

  float acc[D / 2];
  float m[2], l[2], alpha[2];
  float sc[64];
  uint32_t pa[TK / 16][4];
  uint32_t g = 0;

  for (int j = 0;; ++j) {
    const int qb = j % 2;
    mbar_wait(&sm.q_full[qb], (j / 2) & 1);
    const int w = __shfl_sync(0xffffffffu, *reinterpret_cast<volatile int*>(&sm.item[qb]), 0);
    if (w < 0) break;
    const Item item = item_at(w, p);
    const int r_lo = item.q0 + 64 * c;            // first query row of the warpgroup
    const int row0 = r_lo + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
    auto is_edge = [&](int k0) {
      return (k0 + TK > p.T_len) || (p.causal && k0 + TK - 1 > r_lo) ||
             (p.window > 0 && r_lo + 63 - k0 >= p.window);
    };
    const uint32_t q_addr = smem_u32(sm.q[qb][0]) + c * 64 * 128;
    if constexpr (SCALE_Q) {
      scale_q_rows<D>(reinterpret_cast<uint8_t*>(sm.q[qb][0]) + c * 64 * 128, p.q_scale);
      warpgroup_sync(3 + c);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = NEG_INF;             // running max, in S's domain (softmax_tile)
    l[0] = l[1] = 0.f;                 // this thread's part of the row sums

    // the item's first kv tile: S, softmax
    uint32_t s = g % STAGES;
    mbar_wait(&sm.full_k[s], (g / STAGES) & 1);
    turn_wait(my_turn);
    wgmma_fence();
    issue_qk<D>(sc, q_addr, smem_u32(sm.k[s][0]));
    turn_pass(other_turn);
    if (j > 0 && threadIdx.x % 128 == 0) {
      tma_store_wait_read();           // the previous item's O has left its Q buffer
      mbar_arrive(&sm.q_empty[1 - qb]);
    }
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&sm.empty_k[s]);
    softmax_tile<PROBS_BF16>(sc, m, l, alpha, p, row0, col0, item.kt_hi * TK,
                 is_edge(item.kt_hi * TK));
    pack_p(pa, sc);

    for (int it = 1; it < item.n_tiles; ++it) {
      const uint32_t gp = g + it - 1;              // the previous tile: its V
      s = (g + it) % STAGES;
      const int k0 = (item.kt_hi - it) * TK;
      mbar_wait(&sm.full_k[s], ((g + it) / STAGES) & 1);
      fence_regs(acc);
      turn_wait(my_turn);
      wgmma_fence();
      issue_qk<D>(sc, q_addr, smem_u32(sm.k[s][0]));
      mbar_wait(&sm.full_v[gp % STAGES], (gp / STAGES) & 1);
      issue_pv<D>(acc, pa, smem_u32(sm.v[gp % STAGES][0]));
      turn_pass(other_turn);
      wgmma_wait<1>();                  // S done, P V of the previous tile may still run
      fence_regs(sc);
      mbar_arrive(&sm.empty_k[s]);
      softmax_tile<PROBS_BF16>(sc, m, l, alpha, p, row0, col0, k0, is_edge(k0));
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&sm.empty_v[gp % STAGES]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
      pack_p(pa, sc);
    }

    const uint32_t gl = g + item.n_tiles - 1;     // the last tile: its V
    mbar_wait(&sm.full_v[gl % STAGES], (gl / STAGES) & 1);
    fence_regs(acc);
    turn_wait(my_turn);
    wgmma_fence();
    issue_pv<D>(acc, pa, smem_u32(sm.v[gl % STAGES][0]));
    turn_pass(other_turn);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.empty_v[gl % STAGES]);
    g += item.n_tiles;

    // epilogue: o = acc / l in bf16, written over this warpgroup's 64 rows
    // of the Q buffer (its products are done) in the 128-byte swizzled
    // layout, then stored by TMA, which clips rows past T and columns past
    // dv. The Q buffer is released once the store has read it, which is
    // checked after the next item's first product is issued.
    uint8_t* ob = reinterpret_cast<uint8_t*>(sm.q[qb][0]) + c * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int row = 16 * warp + lane / 4 + 8 * r;        // within the warpgroup's 64
      if constexpr (LSE) {   // m and l are in the exp2 domain: back to natural units
        if (lane % 4 == 0 && r_lo + row < p.T_len)
          p.lse[((int64_t)item.b * p.H + item.h) * p.T_len + r_lo + row] =
              (m[r] + log2f(l[r])) * LN2;
      }
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int chunk = (jj % 8) ^ (row % 8);             // the swizzled 16-byte chunk
        *reinterpret_cast<__nv_bfloat162*>(
            ob + (jj / 8) * BOX_BYTES + row * 128 + chunk * 16 + col0 * 2) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * r] * inv, acc[4 * jj + 2 * r + 1] * inv);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(3 + c);
    if (threadIdx.x % 128 == 0 && r_lo < p.T_len) {
#pragma unroll
      for (int cb = 0; cb < D / BOX; ++cb)
        tma_store(map_o, ob + cb * BOX_BYTES, cb * BOX, item.h, r_lo, item.b);
      tma_store_commit();
    }
  }
  if (threadIdx.x % 128 == 0) tma_store_wait_read();   // before shared memory goes
  // consumer 1 passed the turn once more than consumer 0 took it; take it
  // so that no arrival is left on barrier 1
  if (c == 0) turn_wait(my_turn);
}

// Persistent: one block per SM walks work items until the counter runs out.
// The producer's one thread takes each next item, loads its Q into the
// free one of two Q buffers and streams its K and V tiles through the ring;
// it tells the consumers the item beside Q, and -1 when there is none.
template <int D, bool SCALE_Q, bool PROBS_BF16, bool LSE>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.q_full[b], 1);
      mbar_init(&sm.q_empty[b], 2);           // one thread of each consumer
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full_k[s], 1);
      mbar_init(&sm.full_v[s], 1);
      mbar_init(&sm.empty_k[s], 2 * 128);     // every consumer thread arrives
      mbar_init(&sm.empty_v[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      uint32_t g = 0;
      for (int j = 0;; ++j) {
        const int qb = j % 2;
        mbar_wait(&sm.q_empty[qb], ((j / 2) & 1) ^ 1);   // the first round is free
        const int w = j == 0 ? blockIdx.x : gridDim.x + atomicAdd(p.next_item, 1);
        if (w >= p.n_items) {
          sm.item[qb] = -1;
          mbar_arrive(&sm.q_full[qb]);
          break;
        }
        sm.item[qb] = w;
        const Item item = item_at(w, p);
        const int kvh = item.h / (p.H / p.KV);
        mbar_expect_tx(&sm.q_full[qb], TQ * D * 2);
#pragma unroll
        for (int cb = 0; cb < D / BOX; ++cb)
          tma_load(sm.q[qb][cb], &map_q, &sm.q_full[qb], cb * BOX, item.h, item.q0, item.b);
        for (int it = 0; it < item.n_tiles; ++it, ++g) {
          const uint32_t s = g % STAGES;
          const uint32_t parity = ((g / STAGES) & 1) ^ 1;
          const int k0 = (item.kt_hi - it) * TK;
          mbar_wait(&sm.empty_k[s], parity);
          mbar_expect_tx(&sm.full_k[s], TK * D * 2);
#pragma unroll
          for (int cb = 0; cb < D / BOX; ++cb)
            tma_load(sm.k[s][cb], &map_k, &sm.full_k[s], cb * BOX, kvh, k0, item.b);
          mbar_wait(&sm.empty_v[s], parity);
          mbar_expect_tx(&sm.full_v[s], TK * D * 2);
#pragma unroll
          for (int cb = 0; cb < D / BOX; ++cb)
            tma_load(sm.v[s][cb], &map_v, &sm.full_v[s], cb * BOX, kvh, k0, item.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consumer<D, SCALE_Q, PROBS_BF16, LSE>(sm, &map_o, p);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// lookup (so the library links against nothing but the runtime).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous (B, T, heads, d) bf16 tensor, boxes of
// [rows of t][64 columns of d], 128-byte swizzle, zero fill out of bounds.
// Returns the CUresult.
int encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int d, int heads,
               int T_len, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)T_len,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)d * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T_len};   // bytes
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                 strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NO_ENCODE = 20000;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a refused tensor map

template <int D, bool SCALE_Q, bool PROBS_BF16, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 int* counter, int B, int T_len, int H, int KV, int dh, float scale,
                 int causal, int window, cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  CUtensorMap mq, mk, mv, mo;
  int err = encode_map(fn, &mq, q, dh, H, T_len, B, TQ);
  if (!err) err = encode_map(fn, &mk, k, dh, KV, T_len, B, TK);
  if (!err) err = encode_map(fn, &mv, v, dh, KV, T_len, B, TK);
  if (!err) err = encode_map(fn, &mo, o, dh, H, T_len, B, 64);   // a warpgroup's rows
  if (err) return ERR_ENCODE + err;
  const int smem = (int)sizeof(Smem<D>) + 1024;   // + room to align the base
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, SCALE_Q, PROBS_BF16, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  Params p;
  p.next_item = counter;
  p.T_len = T_len;
  p.H = H;
  p.KV = KV;
  p.B = B;
  p.n_qt = (T_len + TQ - 1) / TQ;
  p.n_items = p.n_qt * B * H;
  p.causal = causal;
  p.window = window;
  p.score_scale = (SCALE_Q ? 1.f : scale) * (PROBS_BF16 ? 1.f : LOG2E);
  p.q_scale = scale;
  p.lse = lse;
  const int grid = p.n_items < sms ? p.n_items : sms;   // one block per SM
  flash_fwd_wgmma_kernel<D, SCALE_Q, PROBS_BF16, LSE>
      <<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
  return (int)cudaGetLastError();
}

template <bool SCALE_Q, bool PROBS_BF16, bool LSE>
int launch_fma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
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
        flash_fwd_kernel<SCALE_Q, PROBS_BF16, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<SCALE_Q, PROBS_BF16, LSE><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), T_len, H, KV, dh, dv, scale, causal, window, lse);
  return (int)cudaGetLastError();
}

template <bool SCALE_Q, bool PROBS_BF16, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, void* counter,
           int B, int T_len, int H, int KV, int dh, int dv, float scale, int causal,
           int window, int is_bf16, cudaStream_t st) {
  if (!is_bf16)
    return launch_fma<SCALE_Q, PROBS_BF16, LSE>(q, k, v, o, lse, B, T_len, H, KV, dh, dv,
                                                scale, causal, window, st);
  if (dh != dv) return (int)cudaErrorInvalidValue;
  int* ctr = static_cast<int*>(counter);
  switch (dh) {
    case 16:
    case 32:
    case 64:
      return launch_wgmma<64, SCALE_Q, PROBS_BF16, LSE>(q, k, v, o, lse, ctr, B, T_len, H,
                                                        KV, dh, scale, causal, window, st);
    case 128:
      return launch_wgmma<128, SCALE_Q, PROBS_BF16, LSE>(q, k, v, o, lse, ctr, B, T_len, H,
                                                         KV, dh, scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. window <= 0 means none.
// scale_in_q, probs_bf16: the reference's attention flags, 0 or 1.
// lse: (B, H, T) f32 to receive each row's log-sum-exp, or null; only
// without the flags.
// counter: one int on the card, zero, that the bf16 kernel uses to hand out
// work (unused for f32). Requires B, T_len >= 1 and H % KV == 0; f32:
// 1 <= dh, dv <= 128; bf16: dh == dv in {16, 32, 64, 128}, 16-byte aligned
// pointers and 16-byte multiple strides (all checked by the Python
// wrapper). Returns
// cudaGetLastError() (or the attribute call's error), 10000 + the CUresult
// if the driver refuses a tensor map, 20000 if it has no
// cuTensorMapEncodeTiled.
extern "C" int flash_attn_fwd_launch(const void* q, const void* k, const void* v,
                                     void* o, float* lse, void* counter, int B, int T_len,
                                     int H, int KV, int dh, int dv, float scale,
                                     int causal, int window, int scale_in_q,
                                     int probs_bf16, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lse != nullptr && (scale_in_q || probs_bf16)) return (int)cudaErrorInvalidValue;
  auto* fn = lse != nullptr ? &launch<false, false, true>
           : scale_in_q ? (probs_bf16 ? &launch<true, true, false> : &launch<true, false, false>)
                        : (probs_bf16 ? &launch<false, true, false> : &launch<false, false, false>);
  return fn(q, k, v, o, lse, counter, B, T_len, H, KV, dh, dv, scale, causal, window,
            is_bf16, st);
}
