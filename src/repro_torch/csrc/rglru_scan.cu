// RG-LRU gated linear recurrence  h_t = exp(log_a_t) * h_{t-1} + b_t  (f32).
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py `rglru_scan` (body
// `_kernel`), the Pallas TPU kernel that steps the recurrence over time
// blocks with the running state in VMEM scratch.  Same interface:
// (log_a, b, h0) -> (h for every step, h_last).
//
// What bounds it on the H100: every element is read twice (log_a, b) and
// written once (h), with three operations on it, so device-memory bandwidth
// bounds it: (1, 256, 2560) is 7.9 MB, 2.3 us at 3.35 TB/s.  The recurrence
// is sequential in time and independent across (batch, channel).
// Design: one thread per (batch row, channel), h held in a register across
// the time loop; neighbouring threads own neighbouring channels, so every
// load and store is coalesced along W.  The loads of U time steps are
// issued before their U dependent steps, so each thread keeps 2U loads in
// flight instead of waiting on memory once per step.  Arithmetic is IEEE
// and unfused (expf, __fmul_rn then __fadd_rn), so the result is bit-exact
// with the plain PyTorch version that steps `a[:, t] * h + b[:, t]`.
#include "common.cuh"

namespace {

constexpr int NT = 64;  // threads per block: 40 blocks at W = 2560, B = 1
constexpr int U = 16;   // time steps whose loads are in flight together

// grid (ceil(W / NT), B), block NT threads
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)row * S * W + w;
  float hv = h0[(size_t)row * W + w];
  for (int t0 = 0; t0 < S; t0 += U) {
    float la[U], bb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        la[u] = log_a[base + (size_t)(t0 + u) * W];
        bb[u] = b[base + (size_t)(t0 + u) * W];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        hv = __fadd_rn(__fmul_rn(expf(la[u]), hv), bb[u]);
        h[base + (size_t)(t0 + u) * W] = hv;
      }
    }
  }
  h_last[(size_t)row * W + w] = hv;
}

}  // namespace

// log_a, b (B, S, W) f32, h0 (B, W) f32 -> h (B, S, W) f32, h_last (B, W) f32
extern "C" int rglru_scan_f32(const void* log_a, const void* b, const void* h0,
                              void* h, void* h_last, int B, int S, int W,
                              void* stream) {
  dim3 grid(ceil_div(W, NT), B);
  rglru_scan_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)b, (const float*)h0, (float*)h,
      (float*)h_last, S, W);
  return (int)cudaGetLastError();
}
