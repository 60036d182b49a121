// Per-channel int8 KV quantize / dequantize.
//
// Replaces: src/repro/kernels/kv_quant/kernel.py `kv_quantize_2d` (bodies
// `_absmax_kernel` and `_quant_kernel`) and `kv_dequantize_2d` (body
// `_dequant_kernel`), the Pallas TPU kernels the chunk store runs when a
// chunk is encoded for a sub-HBM tier and decoded on promotion.  On a 2D
// view (R, C), C the channel (last) axis:
//     scales[c] = max(max_r |x[r, c]|, 1e-12) / 127
//     q[r, c]   = clip(round_half_even(x[r, c] / scales[c]), -127, 127)
//     out[r, c] = (float(q[r, c]) * scales[c]) rounded once to the dtype
// The divide is a true IEEE divide (__fdiv_rn, not a multiply by 1/s) and
// the rounding rintf (half to even, not roundf), both as the reference;
// the file is built without --use_fast_math, so codes and scales are
// bit-identical to the plain PyTorch version.
//
// What bounds it on the H100: a few operations per element, so device-
// memory bytes: one 16-token chunk of all 36 layers' K is 1.2 MB of bf16 in
// and 0.6 MB of int8 out, well under a microsecond at 3.35 TB/s.  Design:
// the absmax is the TPU kernel's sequential row reduction made parallel:
// blocks over (channel group, row group) reduce their rows with
// neighbouring threads on neighbouring channels, then combine across
// blocks with atomicMax on the bit pattern of the non-negative f32 absmax
// (order-free, so the result is exact and deterministic); the quantize pass
// is elementwise.  Both passes run on the caller's stream.
#include "common.cuh"

namespace {

constexpr int CT = 128;   // channels per block (threads)
constexpr int RPB = 64;   // rows per block

template <typename T>
__global__ void __launch_bounds__(CT)
absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax, int R, int C) {
  const int c = blockIdx.x * CT + threadIdx.x;
  if (c >= C) return;
  const int r0 = blockIdx.y * RPB, r1 = min(R, r0 + RPB);
  float m = 0.f;
  for (int r = r0; r < r1; ++r) m = fmaxf(m, fabsf(to_f32(x[(long)r * C + c])));
  atomicMax(&amax[c], __float_as_uint(m));  // monotone for m >= 0
}

__device__ __forceinline__ float scale_of(const unsigned* amax, int c) {
  return fmaxf(__uint_as_float(amax[c]), 1e-12f) / 127.0f;
}

template <typename T>
__global__ void __launch_bounds__(CT)
quant_kernel(const T* __restrict__ x, const unsigned* __restrict__ amax,
             int8_t* __restrict__ q, float* __restrict__ scales, int R, int C) {
  const int c = blockIdx.x * CT + threadIdx.x;
  if (c >= C) return;
  const float s = scale_of(amax, c);
  if (blockIdx.y == 0) scales[c] = s;
  const int r0 = blockIdx.y * RPB, r1 = min(R, r0 + RPB);
  for (int r = r0; r < r1; ++r) {
    const float y = rintf(__fdiv_rn(to_f32(x[(long)r * C + c]), s));
    q[(long)r * C + c] = (int8_t)fminf(fmaxf(y, -127.f), 127.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               T* __restrict__ out, long n, int C) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    out[i] = from_f32<T>((float)q[i] * scales[i % C]);
}

template <typename T>
int quantize(const void* x, unsigned* amax, void* q, void* scales, int R, int C,
             cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(amax, 0, sizeof(unsigned) * C, s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(ceil_div(C, CT), ceil_div(R, RPB));
  absmax_kernel<T><<<grid, CT, 0, s>>>((const T*)x, amax, R, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  quant_kernel<T><<<grid, CT, 0, s>>>((const T*)x, amax, (int8_t*)q,
                                      (float*)scales, R, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, C) of `dtype` -> q (R, C) int8, scales (C,) f32; amax (C,) is u32
// scratch.  Two passes (absmax, quantize) on `stream`.
extern "C" int kv_quantize(const void* x, void* amax, void* q, void* scales,
                           int R, int C, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) return quantize<__nv_bfloat16>(x, (unsigned*)amax, q, scales, R, C, s);
  if (dtype == DT_F32) return quantize<float>(x, (unsigned*)amax, q, scales, R, C, s);
  return (int)cudaErrorInvalidValue;
}

// q (R, C) int8, scales (C,) f32 -> out (R, C) of `dtype`.
extern "C" int kv_dequantize(const void* q, const void* scales, void* out,
                             int R, int C, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long n = (long)R * C;
  const int blocks = ceil_div(n, 256 * 4) < 1 ? 1 : ceil_div(n, 256 * 4);
  if (dtype == DT_BF16)
    dequant_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (__nv_bfloat16*)out, n, C);
  else if (dtype == DT_F32)
    dequant_kernel<float><<<blocks, 256, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (float*)out, n, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
