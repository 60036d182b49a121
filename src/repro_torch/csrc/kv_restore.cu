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
// of bf16, 8.5 us at 3.35 TB/s.  The body is the decode routine of
// dequant_rows.cuh (16 channels a thread by 16-byte accesses, a chunk's
// scales held in registers, several rows' loads in flight), shared with
// kv_dequantize; the output is the cache at row t0.
#include "dequant_rows.cuh"

namespace {

template <typename T, bool QUANT, int UNIT>
__global__ void __launch_bounds__(dqr::NT, dqr::MIN_BLOCKS)
kv_restore_kernel(const dqr::RowsArgs a) {
  dqr::dequant_rows<T, QUANT, UNIT>(a);
}

struct RestoreKernels {
  template <typename T, bool QUANT, int UNIT>
  static auto get() { return kv_restore_kernel<T, QUANT, UNIT>; }
};

}  // namespace

// caches[f]: (A, S, chans[f]) of `dtype`; staged[f]: (A, T, chans[f]) int8
// when scales != NULL else `dtype`; scales[f]: (ceil(T / cs), chans[f]) f32.
// Writes slots [slot_lo, slot_lo + n_slots) x rows [t0, t0 + rows) in place,
// rows = min(T, S - t0) (checked by the wrapper).
extern "C" int kv_restore(int nf, void* const* caches, const void* const* staged,
                          const void* const* scales, const int* chans, int S,
                          int T, int t0, int slot_lo, int n_slots, int rows,
                          int cs, int dtype, void* stream) {
  if (nf < 1 || nf > dqr::MAXF) return (int)cudaErrorInvalidValue;
  const bool quant = scales != nullptr;
  const long esz = dtype == DT_BF16 ? 2 : 4;
  dqr::RowsArgs a = {};
  for (int f = 0; f < nf; ++f) {
    a.out[f] = static_cast<char*>(caches[f]) + (long)t0 * chans[f] * esz;
    a.in[f] = staged[f];
    a.scales[f] = quant ? static_cast<const float*>(scales[f]) : nullptr;
    a.out_ss[f] = (long long)S * chans[f];
    a.out_cs[f] = (long long)cs * chans[f];             // the cache's rows in order
    a.in_ss[f] = (long long)T * chans[f];
    a.chans[f] = chans[f];
  }
  a.slot_lo = slot_lo;
  a.rows = rows;
  a.cs = cs;
  cudaStream_t s = (cudaStream_t)stream;
  return quant ? dqr::launch<RestoreKernels, true>(a, nf, n_slots, dtype, s)
               : dqr::launch<RestoreKernels, false>(a, nf, n_slots, dtype, s);
}
