// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a).
//
// Every entry point is `extern "C"`, takes device pointers and the caller's
// cudaStream_t, launches on that stream without synchronising, allocates
// nothing, and returns the cudaError_t of the launch (0 = success).  The
// Python wrappers (repro_torch/kernels/*) check shapes, dtypes and
// contiguity before calling, allocate every output with torch.empty and
// raise on a nonzero return.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with repro_torch/kernels/_build.py
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even: the same single cast PyTorch's .to(torch.bfloat16)
// and jnp's .astype(jnp.bfloat16) make
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

static inline int ceil_div(long a, long b) { return (int)((a + b - 1) / b); }
