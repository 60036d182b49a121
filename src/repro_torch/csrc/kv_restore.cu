// Fused restoration dequant-scatter: one launch per restoration load op.
//
// Replaces: src/repro/kernels/kv_restore/kernel.py `kv_restore_call` (body
// `_restore_kernel`), the Pallas TPU kernel of the I/O pointer.  For every
// attention field f of the op (k and v) in the SAME launch, it writes
//     cache_f[a, t0 + r, c] = (float(staged_f[a, r, c]) * scales_f[r / cs, c])
//                             rounded once to the cache dtype       (int8)
//     cache_f[a, t0 + r, c] = staged_f[a, r, c]                     (raw copy)
// for slots a in [slot_lo, slot_lo + n_slots) and rows r < min(T, S - t0):
// rows past S (the zero-padded tail of a prefix's last chunk) are dropped.
// Caches are (A, S, C_f) views of the live cache, updated in place;
// staging buffers are (A, T, C_f); scales (ceil(T / cs), C_f) f32.  The
// dequant is one f32 multiply and one round-to-nearest-even cast, so it is
// bit-identical to kv_dequantize; the raw copy moves bits.  Any t0, T, slot
// sub-span and channel count is taken: the TPU-only fallbacks of
// src/repro/kernels/kv_restore/ops.py (128-lane channels, chunk-aligned t0,
// slot span reaching A) do not exist here.
//
// What bounds it on the H100: no arithmetic to speak of, so device-memory
// bytes: a 256-token x 18-slot op reads 9.4 MB of int8 and writes 18.9 MB
// of bf16, 8.5 us at 3.35 TB/s.  Design: a grid-stride elementwise pass
// with neighbouring threads on neighbouring channels (coalesced reads and
// writes), one grid plane per (field, slot) so the kernel computes only
// in-row offsets.  Simple first: one element per thread step (no vector
// loads yet).
#include "common.cuh"

namespace {

constexpr int MAXF = 4;

struct RestoreArgs {
  void* cache[MAXF];
  const void* staged[MAXF];
  const float* scales[MAXF];
  int chans[MAXF];
  int n_slots, S, T, t0, slot_lo, rows, cs;
};

// grid (blocks over rows x C, n_slots, n_fields)
template <typename T, bool QUANT>
__global__ void __launch_bounds__(256) kv_restore_kernel(RestoreArgs a) {
  const int f = blockIdx.z;
  const int slot = a.slot_lo + blockIdx.y;
  const int C = a.chans[f];
  const long n = (long)a.rows * C;
  T* cache = static_cast<T*>(a.cache[f]) + ((long)slot * a.S + a.t0) * C;
  const long src0 = (long)slot * a.T * C;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    if constexpr (QUANT) {
      const int r = (int)(i / C), c = (int)(i % C);
      const float s = a.scales[f][(long)(r / a.cs) * C + c];
      const float x = (float)static_cast<const int8_t*>(a.staged[f])[src0 + i];
      cache[i] = from_f32<T>(x * s);
    } else {
      cache[i] = static_cast<const T*>(a.staged[f])[src0 + i];
    }
  }
}

template <typename T>
int launch(const RestoreArgs& a, int nf, bool quant, cudaStream_t stream) {
  long n = 1;
  for (int f = 0; f < nf; ++f) {
    const long nf_el = (long)a.rows * a.chans[f];
    n = n > nf_el ? n : nf_el;
  }
  // ~4 elements per thread: grid-stride covers the rest
  dim3 grid(ceil_div(n, 256 * 4), a.n_slots, nf);
  if (quant)
    kv_restore_kernel<T, true><<<grid, 256, 0, stream>>>(a);
  else
    kv_restore_kernel<T, false><<<grid, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// caches[f]: (A, S, chans[f]) of `dtype`; staged[f]: (A, T, chans[f]) int8
// when scales != NULL else `dtype`; scales[f]: (ceil(T / cs), chans[f]) f32.
// Writes slots [slot_lo, slot_lo + n_slots) x rows [t0, t0 + rows) in place,
// rows = min(T, S - t0) (checked by the wrapper).
extern "C" int kv_restore(int nf, void* const* caches, const void* const* staged,
                          const void* const* scales, const int* chans, int S,
                          int T, int t0, int slot_lo, int n_slots, int rows,
                          int cs, int dtype, void* stream) {
  if (nf < 1 || nf > MAXF) return (int)cudaErrorInvalidValue;
  RestoreArgs a;
  const bool quant = scales != nullptr;
  for (int f = 0; f < MAXF; ++f) {
    a.cache[f] = f < nf ? caches[f] : nullptr;
    a.staged[f] = f < nf ? staged[f] : nullptr;
    a.scales[f] = quant && f < nf ? static_cast<const float*>(scales[f]) : nullptr;
    a.chans[f] = f < nf ? chans[f] : 0;
  }
  a.n_slots = n_slots;
  a.S = S;
  a.T = T;
  a.t0 = t0;
  a.slot_lo = slot_lo;
  a.rows = rows;
  a.cs = cs;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DT_BF16) return launch<__nv_bfloat16>(a, nf, quant, s);
  if (dtype == DT_F32) return launch<float>(a, nf, quant, s);
  return (int)cudaErrorInvalidValue;
}
