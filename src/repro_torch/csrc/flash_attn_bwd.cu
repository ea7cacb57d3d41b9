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
// Two launches a call. bf16: flash_bwd_prep_kernel (D and lse * log2 e
// into (B, H, T) rows padded to whole 64-row tiles with zeros, 8 lanes a
// row, 16-byte loads), then flash_bwd_wgmma_kernel. f32: flash_bwd_dot_kernel
// (D), then the two FMA kernels (below).
//
// bf16 (dh == dv in {16, 32, 64, 128}; 16 and 32 run the dh 64 instance,
// the tensor maps zero-filling the extra columns). What bounds it:
// operations. At chatglm3-6b's training shape (B=4, T=2048, H=32, KV=2,
// dh=128, causal) its five products are 2.5x the forward's, 3.44e11 FLOP,
// 0.348 ms at the H100's 989 TFLOP/s bf16 rate, against ~0.07 ms to move
// its inputs and outputs once. So the design feeds the tensor cores, keeps
// every product to five and moves as little through L2 as the balance of
// the work allows:
//   * A work item is 128 keys of one kv head and batch row and one slice of
//     the group's H/KV query heads (two slices when the group has more than
//     one head). Its K and V stay in shared memory while it walks every
//     64-row query tile that can see one of its keys, for each head of its
//     slice. Consumer warpgroup c owns keys 64 c..64 c + 63 and takes every
//     step: S^T = K Q^T, then dP^T = V dO^T (wgmma SS, both K-major as
//     loaded, each its own commit group, so P^T = exp2(S^T scale log2 e -
//     lse log2 e) is taken while dP^T runs); masks only on tiles that
//     cross the diagonal, the window's edge or T; dV += P^T dO (wgmma RS:
//     P^T, rounded to bf16, is the A operand straight from the
//     accumulators; dO is an MN-major B straight from its TMA tile), dS^T =
//     P^T (dP^T - D) while dV runs, dK += dS^T Q (RS, Q MN-major); dS^T in
//     bf16 to shared memory, and, once both consumers' halves are there,
//     consumer c's half of the columns of the dQ contribution dS K over all
//     128 keys (wgmma SS, dS^T read transposed, K MN-major). Nothing is
//     transposed in memory. Consumer 1 issues each step's first products
//     after consumer 0 (named barrier 4), so one's softmax runs under the
//     other's products.
//   * Why 128 keys: each Q, dO tile loaded and each dQ tile added serves
//     twice the keys that 64-key items would, half the L2 traffic per
//     product, and the dQ reduce-adds are the costliest part of the
//     kernel's dQ path (scripts/k2b_parts.py times each part). Why slices:
//     128-key items over the whole group would be 128 items for 132 SMs,
//     the longest twice the mean; slices make 256, balanced to 0.97.
//   * dK and dV of the item's keys stay in registers across the slice's
//     heads. Where the group is split, each slice writes its part of its
//     half key tile in f32 to scratch and counts itself in (atomicAdd);
//     the second to come adds the first's part to its own and writes the
//     rows. Two terms add the same either way round, so the sum is the
//     same on every run.
//   * Warp specialisation, 3 warpgroups a block: the producer warpgroup's
//     thread 0 issues every TMA load (K and V once an item; Q, dO and the
//     tile's lse * log2 e and D a step, into a ring of 2 stages with
//     full/empty mbarriers), its warp 1 delivers the dQ contributions
//     (below), and it gives its registers up with setmaxnreg (32 / 232: at
//     24 / 240 the producer spills, at 32 / 240 the register file is short
//     and the block never starts).
//   * Persistent grid of one block per SM; every item, the first included,
//     comes from a counter in device memory, in order of ascending key
//     tile: the most causal work first, so the longest items start first
//     and the short ones fill the tail.
//   * dQ in a fixed order, without atomics from registers. Each dQ tile (b,
//     h, 64 query rows) has a chain of contributors: the items of the key
//     tiles that can see it, in ascending order (dq_chain). Contributions
//     are summed in an f32 scratch the caller provides, one tile per (b,
//     h, query tile), each consumer's half in its accumulator's own
//     register order (stores and loads are whole 16-byte vectors), with an
//     int32 count per tile of the contributions it holds, zero at launch.
//     The consumers copy a step's dQ tile into one of two shared buffers
//     and go on; the delivery warp waits until the tile's count equals its
//     place in the chain, then stores it (the first contributor: no
//     memset) or reduce-adds it (cp.reduce.async.bulk .add.f32, in L2) with
//     one bulk copy, waits until the copy's writes are complete and then
//     raises the count (release). The last contributor (the diagonal key
//     tile when causal) hands nothing over: its consumers wait for the
//     count, read the sum, add their own part and write dq * scale in
//     bf16, so there is no post-pass. Each tile's additions come in one
//     order on every run, so the result has the same bits on every run.
//   * Deadlock freedom: an item waits only for items of lower key tiles,
//     which the counter handed out earlier, to blocks that are running (a
//     block takes an item only when it runs), and each block finishes its
//     items in the order it took them.
//   * The walk goes over query tiles in descending order, the slice's heads
//     inside: every item of one (kv head, batch, slice) reaches a dQ tile
//     at the same step, so a link of a chain costs one delivery's latency
//     once, not a step each time.
// Shared memory at dh 128: K, V 64 KB + ring 2 x 32.5 KB + dS^T 2 x 16 KB
// (by step parity: the other consumer may still read the last one) + dQ
// buffers 2 x 32 KB = 225 KB.
//
// f32 (dh, dv <= 128; only the small f32 references reach it): a dK/dV
// kernel per (16-key tile, kv head, batch) looping over the group's heads
// and a dQ kernel per (16-query tile, head, batch), blocks of 256 threads
// over 16 x 16 tiles with FP32 FMAs, exp by expf; they recompute S and dP
// (7 products) and need no scratch.
#include <cuda.h>   // CUtensorMap and its enums; the encode call is looked up at run time
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
// Pre-pass: D = rowsum(dO o O); for bf16 also lse * log2 e
// ---------------------------------------------------------------------------
// f32: one warp per row (b, t, h): D into (B, H, T).
__global__ void flash_bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                                     float* __restrict__ dsum, int rows, int T_len, int H,
                                     int dv) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;   // (b * T + t) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* orow = o + (int64_t)row * dv;
  const float* drow = dout + (int64_t)row * dv;
  float acc = 0.f;
  for (int d = lane; d < dv; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, bt = row / H;
    dsum[((int64_t)(bt / T_len) * H + h) * T_len + bt % T_len] = acc;
  }
}

// bf16: 8 lanes per row (b, t, h) with t < Tp, 16-byte loads (dv a multiple
// of 8): D and lse * log2 e into (B, H, Tp); rows past T get zeros.
__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse, float* __restrict__ dsum,
                                      float* __restrict__ lse2, int rows, int T_len, int Tp,
                                      int H, int dv) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 8;    // (b * Tp + t) * H + h
  const int sub = threadIdx.x % 8;
  if (row >= rows) return;                      // whole 8-lane groups leave together
  const int h = row % H, bt = row / H;
  const int t = bt % Tp, b = bt / Tp;
  uint4 x[2], y[2];                             // dv <= 128: two 16-byte loads a lane
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int d = 8 * sub + 64 * k;
    x[k] = y[k] = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_len && d < dv) {
      const int64_t at = (((int64_t)b * T_len + t) * H + h) * dv + d;
      x[k] = *reinterpret_cast<const uint4*>(o + at);
      y[k] = *reinterpret_cast<const uint4*>(dout + at);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x[k]);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(xs[i]), c = __bfloat1622float2(ys[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
  const unsigned group = 0xffu << (threadIdx.x % 32 / 8 * 8);
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(group, acc, off);
  if (sub == 0) {
    const int64_t bh = (int64_t)b * H + h;
    dsum[bh * Tp + t] = acc;
    lse2[bh * Tp + t] = t < T_len ? lse[bh * T_len + t] * LOG2E : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + mbarrier rings + wgmma, one instance per D in {64, 128}
// ---------------------------------------------------------------------------
constexpr int BQ = 64;                   // queries of a step: one wgmma M / N
constexpr int BKW = 64;                  // keys of each consumer warpgroup
constexpr int BK = 2 * BKW;              // keys of an item
constexpr int BOX = 64;                  // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int QBOX_BYTES = BQ * BOX * 2; // a box of a Q or dO tile, 8 KB
constexpr int KBOX_BYTES = BK * BOX * 2; // a box of a K or V tile, 16 KB
constexpr int STAGES = 2;                // Q / dO ring depth
constexpr int WG_THREADS = 384;          // producer warpgroup + 2 consumer warpgroups

// Every bf16 tile is D / BOX boxes of [rows][64 columns], 128-byte
// swizzled; the base is 1024-byte aligned and so is every tile.
template <int D>
struct Smem {
  __nv_bfloat16 k[D / BOX][BK * BOX];           // the item's K and V
  __nv_bfloat16 v[D / BOX][BK * BOX];
  __nv_bfloat16 q[STAGES][D / BOX][BQ * BOX];   // a step's Q and dO
  __nv_bfloat16 dout[STAGES][D / BOX][BQ * BOX];
  __nv_bfloat16 ds[2][BK * BQ];                 // dS^T [key][query], swizzled, by step parity
  float dq[2][BQ * D];                          // dQ tiles handed to the delivery warp
  float lse2[STAGES][BQ], dd[STAGES][BQ];       // the step's lse * log2 e and D
  uint64_t full[STAGES], empty[STAGES];
  uint64_t kv_full, kv_empty;
  uint64_t dq_full[2], dq_empty[2];
  int item;                                     // the item in K and V, -1: none
  int dq_tile[2], dq_place[2];                  // the dQ tile in each buffer, -1: stop
  int dkv_order[2];                             // each consumer's turn in its key tile
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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d, int head, int t, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(head), "r"(t), "r"(batch)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(smem_u32(bar))
      : "memory");
}

// A whole tile from shared to global memory: stored, or added element-wise
// in f32 where it lands (L2).
__device__ __forceinline__ void bulk_store(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Every committed bulk copy of this thread has read its source ...
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and has completed its writes.
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy and async-proxy accesses to global memory.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A dQ tile's count of added contributions: wait for a value, publish one.
__device__ __forceinline__ void count_wait(const int* count, int value) {
  int seen;
  do {
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(seen) : "l"(count) : "memory");
  } while (seen < value);
}
__device__ __forceinline__ void count_publish(int* count, int value) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(count), "r"(value) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
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
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across its issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

#define ACC8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REGS64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), both from shared memory,
// K-major. scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x 16) * B (16 x N), both from shared memory,
// MN-major (the transposed forms).
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24),
        ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8
#undef REGS32
#undef REGS64

// Named barriers: 1 for both consumer warpgroups, 2 + c for consumer c.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + c) : "memory");
}
// Named barrier 4 orders the consumers' issue of each step's first products.
__device__ __forceinline__ void turn_pass() {
  asm volatile("bar.arrive 4, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_wait() {
  asm volatile("bar.sync 4, 256;\n" ::: "memory");
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
  int* next_item;             // work counter, zero at launch
  int* dq_count;              // (B, H, n_q) contributions in each dQ tile, zero at launch
  int* dkv_count;             // (B, KV, n_k, 2) slices done with each half key tile, zero
  float* dq_acc;              // (B, H, n_q) tiles of BQ x D f32 (see consumer_step)
  float* dkv_acc;             // (B, KV, n_k, slice, consumer, dK / dV) BKW x D f32
  const float* lse2;          // (B, H, Tp): lse * log2 e, zero past T
  const float* dd;            // (B, H, Tp): D, zero past T
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int T_len, Tp, H, KV, B, G, NS, n_q, n_k, n_items, causal, window, dh;
  float sl2;                  // scale * log2 e
  float scale;
};

// The schedule (kernels/flash_attn_bwd.py has a twin of this arithmetic
// that tests check). Query tiles have BQ = 64 rows, key tiles BK = 128. A
// (query tile, key tile) pair is live when one of its (q, k) pairs is:
// k0 <= q1 (causal) and q0 - k1 < window, with q1, k1 the tiles' last rows
// below T.
//
// The query tiles qt_lo..qt_hi that key tile kt's items walk.
__device__ __forceinline__ int2 item_qtiles(int kt, const Params& p) {
  const int k1 = min(kt * BK + BK, p.T_len) - 1;
  return make_int2(p.causal ? kt * BK / BQ : 0,
                   p.window > 0 ? min(p.n_q - 1, (k1 + p.window - 1) / BQ) : p.n_q - 1);
}
// The key tiles that add to dQ tile qt, in the order they add: lo..hi.
__device__ __forceinline__ int2 dq_chain(int qt, const Params& p) {
  const int q0 = qt * BQ, q1 = min(q0 + BQ, p.T_len) - 1;
  return make_int2(p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0,
                   p.causal ? q1 / BK : p.n_k - 1);
}

// Item w: key tile w / (B KV NS) (ascending: the most causal work first),
// then the batch row, kv head and slice of the group's heads (NS = 2
// slices of ceil(G / 2) and floor(G / 2) heads when G > 1). It takes one
// step per (query tile, head of its slice), from qt_hi down, the heads
// inside.
struct Item {
  int kt, b, kvh, slice, h0, nh, qt_lo, qt_hi, n_steps;
};
__device__ __forceinline__ Item item_at(int w, const Params& p) {
  Item it;
  it.kt = w / (p.B * p.KV * p.NS);
  const int r = w % (p.B * p.KV * p.NS);
  it.b = r / (p.KV * p.NS);
  it.kvh = r / p.NS % p.KV;
  it.slice = r % p.NS;
  const int first = (p.G + 1) / 2;
  it.h0 = it.kvh * p.G + (it.slice ? first : 0);
  it.nh = p.NS == 1 ? p.G : it.slice ? p.G - first : first;
  const int2 qts = item_qtiles(it.kt, p);
  it.qt_lo = qts.x;
  it.qt_hi = qts.y;
  it.n_steps = it.nh * (qts.y - qts.x + 1);
  return it;
}

// The producer's thread 0: takes each item, loads its K and V, and streams
// its steps' Q, dO, lse * log2 e and D through the ring. `g` counts steps
// over the block's items and gives each step its stage and phase.
template <int D>
__device__ __forceinline__ void producer(Smem<D>& sm, const CUtensorMap* map_q,
                                         const CUtensorMap* map_k, const CUtensorMap* map_v,
                                         const CUtensorMap* map_do, const Params& p) {
  uint32_t g = 0;
  for (int j = 0;; ++j) {
    mbar_wait(&sm.kv_empty, (j & 1) ^ 1);        // the first round is free
    const int w = atomicAdd(p.next_item, 1);
    if (w >= p.n_items) {
      sm.item = -1;
      mbar_arrive(&sm.kv_full);
      return;
    }
    sm.item = w;
    const Item it = item_at(w, p);
    mbar_expect_tx(&sm.kv_full, 2 * BK * D * 2);
#pragma unroll
    for (int cb = 0; cb < D / BOX; ++cb) {
      tma_load(sm.k[cb], map_k, &sm.kv_full, cb * BOX, it.kvh, it.kt * BK, it.b);
      tma_load(sm.v[cb], map_v, &sm.kv_full, cb * BOX, it.kvh, it.kt * BK, it.b);
    }
    for (int qt = it.qt_hi; qt >= it.qt_lo; --qt)
      for (int hd = 0; hd < it.nh; ++hd, ++g) {
        const uint32_t st = g % STAGES;
        const int h = it.h0 + hd, q0 = qt * BQ;
        mbar_wait(&sm.empty[st], ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], 2 * BQ * D * 2 + 2 * BQ * 4);
#pragma unroll
        for (int cb = 0; cb < D / BOX; ++cb) {
          tma_load(sm.q[st][cb], map_q, &sm.full[st], cb * BOX, h, q0, it.b);
          tma_load(sm.dout[st][cb], map_do, &sm.full[st], cb * BOX, h, q0, it.b);
        }
        const int vec = (it.b * p.H + h) * p.Tp + q0;
        bulk_load(sm.lse2[st], p.lse2 + vec, BQ * 4, &sm.full[st]);
        bulk_load(sm.dd[st], p.dd + vec, BQ * 4, &sm.full[st]);
      }
  }
}

// Producer warp 1, lane 0: delivers the consumers' dQ tiles in the order
// they hand them over, alternating between the two buffers (tile -1: no
// more), each when the tile's count says it is its turn.
template <int D>
__device__ __forceinline__ void dq_delivery(Smem<D>& sm, const Params& p) {
  for (uint32_t u = 0;; ++u) {
    const int buf = u % 2;
    mbar_wait(&sm.dq_full[buf], (u / 2) & 1);
    const int tile = *reinterpret_cast<volatile int*>(&sm.dq_tile[buf]);
    const int place = *reinterpret_cast<volatile int*>(&sm.dq_place[buf]);
    if (tile < 0) return;
    if (place > 0) count_wait(p.dq_count + tile, place);
    fence_proxy_global();
    float* dst = p.dq_acc + (size_t)tile * (BQ * D);
    if (place == 0) bulk_store(dst, sm.dq[buf], BQ * D * 4);
    else bulk_reduce_add(dst, sm.dq[buf], BQ * D * 4);
    bulk_commit();
    bulk_wait_read();
    mbar_arrive(&sm.dq_empty[buf]);
    bulk_wait_done();
    fence_proxy_global();
    count_publish(p.dq_count + tile, place + 1);
  }
}

// Register layout of a wgmma m64nN accumulator, per warpgroup thread with
// w = warp (0..3), g = lane / 4, t = lane % 4: element 4j + e sits at row
// 16w + g + 8 * (e / 2), column 8j + 2t + e % 2. A register-A fragment for
// k16 step kk holds rows 16w + g (+8) and columns 16kk + 2t (+1),
// 16kk + 8 + 2t (+1): two neighbouring 8-column accumulator groups, so
// P^T and dS^T become A operands in place.
//
// An m64nN accumulator (N columns from col0) times `scale` to bf16 rows
// row0 + 16 w + lane / 4 (+ 8) of (B, T, heads, dh), head `head`; rows past
// T and columns past dh are not written.
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[N / 2],
                                           float scale, int b, int row0, int col0, int heads,
                                           int head, const Params& p) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 16 * warp + lane / 4 + 8 * r;
    if (t >= p.T_len) continue;
    __nv_bfloat16* row = dst + (((int64_t)b * p.T_len + t) * heads + head) * p.dh;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane % 4);
      if (col < p.dh)
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16x2(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

__device__ __forceinline__ void pack_a(uint32_t (&a)[BQ / 16][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// A warpgroup's accumulator to and from memory in register order (thread
// tid's 4 consecutive values at float4 i * 128 + tid). take_rows adds, and
// reads through L2 (another block wrote it).
template <int N>
__device__ __forceinline__ void give_rows(float* dst, const float (&x)[N], int tid) {
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    out[i * 128 + tid] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}
template <int N>
__device__ __forceinline__ void take_rows(float (&x)[N], const float* src, int tid) {
  const float4* in = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 y = __ldcg(in + i * 128 + tid);
    x[4 * i] += y.x;
    x[4 * i + 1] += y.y;
    x[4 * i + 2] += y.z;
    x[4 * i + 3] += y.w;
  }
}

// One step of consumer c: its 64 keys of the item against 64 queries from
// q0 of head h, ring stage st of phase `phase`; `n` counts the block's
// steps (it picks the dS^T buffer) and `dq_uses` the dQ tiles handed over.
template <int D>
__device__ __forceinline__ void consumer_step(Smem<D>& sm, int c, const Item& it, int qt,
                                              int h, uint32_t st, uint32_t phase, uint32_t n,
                                              uint32_t& dq_uses, float (&dk)[D / 2],
                                              float (&dv)[D / 2], const Params& p) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BQ, k0 = it.kt * BK;
  // this consumer's 64 rows of the K and V boxes
  const uint32_t k_addr = smem_u32(sm.k[0]) + c * BKW * 128;
  const uint32_t v_addr = smem_u32(sm.v[0]) + c * BKW * 128;
  const uint32_t q_addr = smem_u32(sm.q[st][0]), do_addr = smem_u32(sm.dout[st][0]);
  mbar_wait(&sm.full[st], phase);

  // S^T = K Q^T, then dP^T = V dO^T, each its own commit group: D / 16
  // steps of k16 along d, 32 bytes along the swizzled row, every 4 steps to
  // the next 64-column box. Consumer 1 issues after consumer 0, so that
  // one's softmax runs while the tensor cores work on the other's products.
  float sc[32], dp[32];
  if (c == 1) turn_wait();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ko = (kk / 4) * KBOX_BYTES + (kk % 4) * 32;
    const uint32_t qo = (kk / 4) * QBOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(sc, sw128_desc(k_addr + ko, 16, 1024), sw128_desc(q_addr + qo, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t ko = (kk / 4) * KBOX_BYTES + (kk % 4) * 32;
    const uint32_t qo = (kk / 4) * QBOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(dp, sw128_desc(v_addr + ko, 16, 1024), sw128_desc(do_addr + qo, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
  if (c == 0) turn_pass();

  // P^T = exp2(S^T scale log2 e - lse log2 e) while dP^T runs; rows are
  // keys, columns queries. Only tiles that cross the diagonal, the window's
  // edge or T are masked.
  wgmma_wait<1>();
  fence_regs(sc);
  const bool edge = k0 + BK > p.T_len || q0 + BQ > p.T_len ||
                    (p.causal && k0 + BK - 1 > q0) ||
                    (p.window > 0 && q0 + BQ - 1 - k0 >= p.window);
  const int key = k0 + c * BKW + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse2[st][8 * j + col0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float pr = fast_exp2(sc[i] * p.sl2 - (e % 2 ? l2.y : l2.x));
      sc[i] = edge && !live(q0 + 8 * j + col0 + e % 2, key + 8 * (e / 2), p.T_len, p.causal,
                            p.window) ? 0.f : pr;
    }
  }
  uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
  pack_a(pa, sc);

  // dV += P^T dO: B is MN-major, a k16 step is 16 query rows (two groups of
  // 8 rows 1024 B apart), the next 64 columns of d the next box
  fence_regs(dv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs(dv, pa[kk], sw128_desc(do_addr + kk * 16 * 128, QBOX_BYTES, 1024));
  wgmma_commit();

  // dS^T = P^T (dP^T - D) while dV runs, then dK += dS^T Q
  wgmma_wait<1>();
  fence_regs(dp);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(&sm.dd[st][8 * j + col0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d2.y : d2.x));
  }
  pack_a(dsa, dp);
  fence_regs(dk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    wgmma_rs(dk, dsa[kk], sw128_desc(q_addr + kk * 16 * 128, QBOX_BYTES, 1024));
  wgmma_commit();

  // dS^T to shared memory, rows 64 c.. of [key][query] in the 128-byte
  // swizzle (a row of 64 queries is one swizzle row), for dQ = dS K; the
  // buffer of the other step parity may still be read by the other
  // consumer's dQ of the previous step
  uint8_t* dsb = reinterpret_cast<uint8_t*>(sm.ds[n % 2]) + c * BKW * 128;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;
      *reinterpret_cast<uint32_t*>(dsb + row * 128 + ((j ^ (row % 8)) * 16) + col0 * 2) =
          dsa[j / 2][(j % 2) * 2 + r];
    }
  fence_proxy_shared();
  consumers_sync();                             // both halves of dS^T are written

  // dQ = dS K over the item's 128 keys, consumer c taking columns
  // c D / 2 ..: A is dS^T read transposed (MN-major), B is K (MN-major),
  // a k16 step is 16 keys. It queues behind dV and dK.
  float dq[D / 4];
  const uint32_t ds_addr = smem_u32(sm.ds[n % 2]);
  const uint32_t kq_addr = smem_u32(sm.k[0]) + c * (D == 128 ? KBOX_BYTES : D);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_ss_tt(dq, sw128_desc(ds_addr + kk * 16 * 128, KBOX_BYTES, 1024),
                sw128_desc(kq_addr + kk * 16 * 128, KBOX_BYTES, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pa);
  fence_regs(dsa);
  fence_regs(dq);
  mbar_arrive(&sm.empty[st]);                   // Q, dO, lse, D of the step are used

  // the tile is BQ x D f32, consumer c's columns at float c * BQ * D / 2,
  // each in register order
  const int2 chain = dq_chain(qt, p);
  const int place = it.kt - chain.x, tile = (it.b * p.H + h) * p.n_q + qt;
  if (it.kt == chain.y) {
    // the last contributor: dq = (the chain's sum + this part) * scale
    if (place > 0) {
      if (tid == 0) count_wait(p.dq_count + tile, place);
      warpgroup_sync(c);
      take_rows(dq, p.dq_acc + (size_t)tile * (BQ * D) + c * (BQ * D / 2), tid);
    }
    store_rows<D / 2>(p.dq, dq, p.scale, it.b, q0, c * (D / 2), p.H, h, p);
  } else {
    // hand the tile to the delivery warp
    const int buf = dq_uses % 2;
    mbar_wait(&sm.dq_empty[buf], ((dq_uses / 2) & 1) ^ 1);
    give_rows(sm.dq[buf] + c * (BQ * D / 2), dq, tid);
    if (c == 0 && tid == 0) {
      sm.dq_tile[buf] = tile;
      sm.dq_place[buf] = place;
    }
    fence_proxy_shared();
    mbar_arrive(&sm.dq_full[buf]);
    ++dq_uses;
  }
}

// Consumer warpgroup c (0 or 1): keys 64 c.. of each item, every step; then
// its dK and dV rows, added to the other slice's where the group is split
// (whichever slice finishes second adds, a + b being b + a).
template <int D>
__device__ __forceinline__ void consumer(Smem<D>& sm, const Params& p) {
  const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  float dk[D / 2], dv[D / 2];
  uint32_t g = 0, dq_uses = 0;
  for (int j = 0;; ++j) {
    mbar_wait(&sm.kv_full, j & 1);
    const int w = __shfl_sync(0xffffffffu, *reinterpret_cast<volatile int*>(&sm.item), 0);
    if (w < 0) {                               // no more items: stop the delivery warp
      const int buf = dq_uses % 2;
      mbar_wait(&sm.dq_empty[buf], ((dq_uses / 2) & 1) ^ 1);
      if (c == 0 && tid == 0) sm.dq_tile[buf] = -1;
      mbar_arrive(&sm.dq_full[buf]);
      return;
    }
    const Item it = item_at(w, p);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    int qt = it.qt_hi, hd = 0;
    for (int s = 0; s < it.n_steps; ++s, ++g) {
      consumer_step<D>(sm, c, it, qt, it.h0 + hd, g % STAGES, (g / STAGES) & 1, g, dq_uses,
                       dk, dv, p);
      if (++hd == it.nh) {
        hd = 0;
        --qt;
      }
    }
    mbar_arrive(&sm.kv_empty);                 // K and V are used

    const int row0 = it.kt * BK + c * BKW;
    if (p.NS > 1) {
      const int half = ((it.b * p.KV + it.kvh) * p.n_k + it.kt) * 2 + c;
      float* mine = p.dkv_acc + ((size_t)(half * 2 + it.slice) * 2) * (BKW * D);
      const float* other = p.dkv_acc + ((size_t)(half * 2 + 1 - it.slice) * 2) * (BKW * D);
      give_rows(mine, dk, tid);
      give_rows(mine + BKW * D, dv, tid);
      __threadfence();
      warpgroup_sync(c);
      if (tid == 0) sm.dkv_order[c] = atomicAdd(p.dkv_count + half, 1);
      warpgroup_sync(c);
      if (sm.dkv_order[c] == 0) continue;       // the other slice adds
      __threadfence();
      take_rows(dk, other, tid);
      take_rows(dv, other + BKW * D, tid);
    }
    store_rows<D>(p.dk, dk, p.scale, it.b, row0, 0, p.KV, it.kvh, p);
    store_rows<D>(p.dv, dv, 1.f, it.b, row0, 0, p.KV, it.kvh, p);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzled tiles want 1024-byte aligned bases
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * 128);          // every consumer thread
    }
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, 2 * 128);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sm.dq_full[b], 2 * 128);
      mbar_init(&sm.dq_empty[b], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (threadIdx.x == 0) producer<D>(sm, &map_q, &map_k, &map_v, &map_do, p);
    else if (threadIdx.x == 32) dq_delivery<D>(sm, p);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consumer<D>(sm, p);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// lookup (so the library links against nothing but the runtime).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous (B, T, heads, d) bf16 tensor, boxes of
// [rows of t][64 columns of d], 128-byte swizzle, zero fill out of bounds. Returns the CUresult.
int encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int d, int heads, int T_len,
               int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)T_len,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)d * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * T_len};   // bytes
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                 box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NO_ENCODE = 20000;   // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a refused tensor map

struct Args {
  int T_len, H, KV, causal, window;
  float scale;
};

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

int launch_dot(const void* o, const void* dout, float* dsum, int B, int T_len, int H, int dv,
               cudaStream_t st) {
  const int rows = B * T_len * H;
  constexpr int WARPS = 8;
  flash_bwd_dot_kernel<<<(rows + WARPS - 1) / WARPS, 32 * WARPS, 0, st>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), dsum, rows, T_len, H, dv);
  return (int)cudaGetLastError();
}

int launch_prep(const void* o, const void* dout, const float* lse, float* dsum, float* lse2,
                int B, int T_len, int Tp, int H, int dv, cudaStream_t st) {
  const int rows = B * Tp * H;
  constexpr int ROWS = 32;                       // 256 threads
  flash_bwd_prep_kernel<<<(rows + ROWS - 1) / ROWS, 8 * ROWS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      lse2, rows, T_len, Tp, H, dv);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dv, float* work, int* counters, int B, int T_len, int H,
                 int KV, int dh, float scale, int causal, int window, cudaStream_t stream) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  CUtensorMap mq, mk, mv, mdo;
  int err = encode_map(fn, &mq, q, dh, H, T_len, B, BQ);
  if (!err) err = encode_map(fn, &mk, k, dh, KV, T_len, B, BK);
  if (!err) err = encode_map(fn, &mv, v, dh, KV, T_len, B, BK);
  if (!err) err = encode_map(fn, &mdo, dout, dh, H, T_len, B, BQ);
  if (err) return ERR_ENCODE + err;
  const int smem = (int)sizeof(Smem<D>) + 1024;   // + room to align the base
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  Params p;
  p.T_len = T_len;
  p.n_q = (T_len + BQ - 1) / BQ;
  p.n_k = (T_len + BK - 1) / BK;
  p.Tp = p.n_q * BQ;
  p.H = H;
  p.KV = KV;
  p.B = B;
  p.G = H / KV;
  p.NS = p.G > 1 ? 2 : 1;
  p.n_items = p.n_k * B * KV * p.NS;
  p.causal = causal;
  p.window = window;
  p.dh = dh;
  p.sl2 = scale * LOG2E;
  p.scale = scale;
  const size_t vec = (size_t)B * H * p.Tp;       // the work layout: flash_attn_bwd_launch
  p.dd = work;
  p.lse2 = work + vec;
  p.dq_acc = work + 2 * vec;
  p.dkv_acc = p.dq_acc + vec * D;
  p.next_item = counters;
  p.dq_count = counters + 1;
  p.dkv_count = p.dq_count + B * H * p.n_q;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  const int grid = p.n_items < sms ? p.n_items : sms;   // one block per SM
  flash_bwd_wgmma_kernel<D><<<grid, WG_THREADS, smem, stream>>>(mq, mk, mv, mdo, p);
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

// Runs the pre-pass and the main kernel(s) on `stream`. is_bf16: 1 for
// bfloat16 tensors, 0 for float32; window <= 0 means none. `work` is f32
// scratch: B H T floats for f32; for bf16, with n_q = ceil(T / 64), Tp =
// 64 n_q, n_k = ceil(T / 128) and D = 64 for dh <= 64, else 128, the D and
// lse * log2 e rows (2 B H Tp), the dQ tiles (B H Tp D) and the dK / dV
// halves of two slices (B KV n_k 512 D). `counters` (bf16 only) is int32,
// 1 + B H n_q + 2 B KV n_k of them, zero: the work counter, each dQ tile's
// count and each half key tile's. Requires B, T_len >= 1 and H % KV == 0;
// f32: 1 <= dh, dv <= 128; bf16: dh == dv in {16, 32, 64, 128},
// contiguous tensors with 16-byte aligned bases (all checked by the Python
// wrapper). Returns the first non-zero cudaGetLastError() of the launches
// (or the attribute call's error), 10000 + the CUresult if the driver
// refuses a tensor map, 20000 if it has no cuTensorMapEncodeTiled.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                                     const void* o, const float* lse, const void* dout,
                                     void* dq, void* dk, void* dv, float* work, int* counters,
                                     int B, int T_len, int H, int KV, int dh, int dvd,
                                     float scale, int causal, int window, int is_bf16,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    const Args p{T_len, H, KV, causal, window, scale};
    const int err = launch_dot(o, dout, work, B, T_len, H, dvd, st);
    if (err) return err;
    return launch_f32(q, k, v, dout, lse, work, dq, dk, dv, B, p, dh, dvd, st);
  }
  if (dh != dvd) return (int)cudaErrorInvalidValue;
  const int Tp = (T_len + BQ - 1) / BQ * BQ;
  const int err = launch_prep(o, dout, lse, work, work + (size_t)B * H * Tp, B, T_len, Tp, H,
                              dvd, st);
  if (err) return err;
  switch (dh) {
    case 16:
    case 32:
    case 64:
      return launch_wgmma<64>(q, k, v, dout, dq, dk, dv, work, counters, B, T_len, H, KV, dh,
                              scale, causal, window, st);
    case 128:
      return launch_wgmma<128>(q, k, v, dout, dq, dk, dv, work, counters, B, T_len, H, KV, dh,
                               scale, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
