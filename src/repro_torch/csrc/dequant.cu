// Blockwise int8 -> bf16/f32 dequantization: out[n, f] = q[n, f] * scale[n, f / qblock].
//
// Replaces the TPU kernel src/repro/kernels/dequant.py::dequant
// (_dequant_kernel), the device tier's stand-in for the paper's LZSS
// decompression.
//
// Bound on an H100: device-memory bytes. Each element reads 1 byte and
// writes 2 (bf16) or 4 (f32) and does one multiply, about 0.3 operations per
// byte, far below the ~20 FP32 operations per byte at which the card's
// arithmetic would become the limit.
//
// Design for that bound: every thread owns 16 consecutive elements of one
// record. They are read as one 16-byte load and, because qblock is a
// multiple of 16, always lie inside one scale block, so the thread reads one
// scale. The results leave as 16-byte stores (two for bf16, four for f32),
// so a warp moves contiguous 512-byte (load) and 1-2 KB (store) spans. The
// grid is (record, chunk block): the record index comes from blockIdx.x, so
// no thread divides 64-bit indices; F only has to be a multiple of qblock
// (no tile constraint), and the last chunk block of a row is masked.
//
// Arithmetic: the int8 value and the scale are widened to f32, multiplied
// once, and rounded with __float2bfloat16_rn (round to nearest even), which
// is the arithmetic of the plain version (kernels/ref.py::dequant_ref); the
// two agree bit for bit.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_scale(const __half* s, int64_t i) {
  return __half2float(s[i]);
}
__device__ __forceinline__ float load_scale(const float* s, int64_t i) {
  return s[i];
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  __align__(16) __nv_bfloat16 o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = __float2bfloat16_rn(v[i]);
  const int4* src = reinterpret_cast<const int4*>(o);
  int4* dst = reinterpret_cast<int4*>(out);
  dst[0] = src[0];
  dst[1] = src[1];
}

__device__ __forceinline__ void store16(float* out, const float* v) {
  float4* dst = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

template <typename ScaleT, typename OutT>
__global__ void dequant_kernel(const int8_t* __restrict__ q,
                               const ScaleT* __restrict__ scales,
                               OutT* __restrict__ out, int64_t f,
                               int chunks_per_row, int qblock) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;   // chunk in the row
  if (c >= chunks_per_row) return;
  const int64_t row = blockIdx.x;
  const int col = c * 16;
  const float s = load_scale(scales, row * (f / qblock) + col / qblock);
  const int64_t e = row * f + col;                       // first element
  const int4 raw = *reinterpret_cast<const int4*>(q + e);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = static_cast<float>(b[i]) * s;
  store16(out + e, v);
}

constexpr int THREADS = 256;

template <typename ScaleT, typename OutT>
int launch(const void* q, const void* scales, void* out, int64_t n, int64_t f,
           int64_t qblock, cudaStream_t stream) {
  const int chunks_per_row = (int)(f / 16);
  dim3 grid((unsigned)n, (unsigned)((chunks_per_row + THREADS - 1) / THREADS));
  dequant_kernel<ScaleT, OutT><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const ScaleT*>(scales),
      static_cast<OutT*>(out), f, chunks_per_row, (int)qblock);
  return (int)cudaGetLastError();
}

}  // namespace

// scale_f16: 1 if scales are float16, 0 if float32.
// out_bf16:  1 for a bfloat16 output, 0 for float32.
// Requires n, f >= 1, f % qblock == 0, qblock % 16 == 0, and 16-byte aligned
// pointers (checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int dequant_launch(const void* q, const void* scales, void* out,
                              int64_t n, int64_t f, int64_t qblock,
                              int scale_f16, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scale_f16) {
    return out_bf16 ? launch<__half, __nv_bfloat16>(q, scales, out, n, f, qblock, st)
                    : launch<__half, float>(q, scales, out, n, f, qblock, st);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(q, scales, out, n, f, qblock, st)
                  : launch<float, float>(q, scales, out, n, f, qblock, st);
}
