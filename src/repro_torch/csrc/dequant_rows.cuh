// The decode routine of the I/O pointer, shared by kv_restore.cu (the fused
// dequant-scatter into the live cache) and kv_quant.cu's kv_dequantize (a
// run's chunks decoded into a fresh buffer for the pool).
//
// Work: rows [0, rows) of slots [slot_lo, slot_lo + n_slots) of up to MAXF
// fields.  Field f reads an (A, T, C_f) staging view whose rows are
// contiguous (row stride C_f, any slot stride) and writes rows of C_f
// elements at the same (slot, row) of its output: row stride C_f, any slot
// stride, and a chunk stride, so that the output may be an (A, T, C_f) view
// (kv_restore: the live cache) or chunk-major (n_chunks, A, cs, C_f), each
// chunk a block as the pool stores it (kv_dequantize):
//     out[slot, r, c] = from_f32<T>(__fmul_rn(float(q[slot, r, c]),
//                                             scales[r / cs, c]))   (int8)
//     out[slot, r, c] = in[slot, r, c]                           (raw copy)
// One f32 multiply and one round-to-nearest-even cast, as the plain
// versions (kv_restore_plain, kv_dequantize_plain) compute it: no FMA, no
// reciprocal, so the result is bit-identical.
//
// What bounds it on the H100: device-memory bytes (an int8 byte in, two
// bf16 bytes out, a multiply between).  Design:
//   * the unit: a thread owns 16 consecutive channels of a row -- one
//     16-byte load of int8 codes (or 16-byte loads of raw elements), one
//     multiply and one cast an element, 16-byte stores;
//   * a thread's unit column is fixed, so its channels need no division,
//     and its rows are consecutive: the chunk's 16 scales are loaded once
//     (four float4 loads) and held in registers for the thread's rows of
//     that chunk (one 32-bit divide a chunk a thread, none an element);
//   * a thread's int8 rows (up to RPT = 4) are loaded before any is used:
//     the whole read of a launch is in flight at once (raw rows: up to 8 a
//     thread, 2 at a time);
//   * bf16 results are swapped between the lanes of a row by shuffles
//     before they are stored, so a warp's 16-byte stores cover whole
//     sectors in order (a lane's own 32 bytes would be two half-sector
//     stores 32 bytes apart);
//   * grid (row tiles, slots, fields): a block computes its slot and field
//     offsets once; rows_plan halves the rows a thread while the grid holds
//     fewer blocks than the card has SMs;
//   * a channel count that is not a multiple of 16, or a pointer or slot
//     stride off 16-byte alignment, takes the scalar instance: one element
//     a unit, the same loops.
// On the H100, 4 int8 rows a thread and the shuffled stores each beat 8 rows
// a thread and a lane's own stores at the serve's load op (PERF.md).
// The host side (rows_plan, launch) is mirrored by kernels/kv_restore
// `rows_plan`, which the CPU tests hold to coverage.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace dqr {

constexpr int NT = 256;              // threads a block
constexpr int MAXF = 4;              // fields a launch
constexpr int RPT = 4;               // rows a thread, at most (twice that for raw rows)
constexpr int TARGET_BLOCKS = 132;   // a block for each of an H100's SMs
// Blocks an SM must hold, for __launch_bounds__: 2 lets ptxas use up to 128
// registers a thread (the int8 bf16 instance takes about 100: 4 rows in
// flight and the shuffled stores); under the limit ptxas picks by default
// it spilled, and so did the raw f32 instance.
constexpr int MIN_BLOCKS = 2;

struct RowsArgs {
  void* out[MAXF];                   // output of field f at slot 0, row 0
  const void* in[MAXF];              // staging view of field f at slot 0, row 0
  const float* scales[MAXF];         // (ceil(rows / cs), C_f) f32, or null (raw)
  long long out_ss[MAXF], in_ss[MAXF];  // slot strides (elements)
  long long out_cs[MAXF];            // output chunk stride: chunk ch's rows at ch * out_cs
  int chans[MAXF];
  int slot_lo, rows, cs, rpt;
};

struct RowsPlan {
  int unit, rpt, tiles;              // channels a unit, rows a thread, grid.x
};

// rows of a tile's row lanes: NT threads over min(units a row, NT) columns
inline int row_lanes(int chans, int unit) {
  const int g = chans / unit;
  return NT / (g < NT ? g : NT);
}

inline RowsPlan rows_plan(const int* chans, int nf, int rows, int n_slots, bool aligned,
                          bool quant) {
  bool vec = aligned;
  for (int f = 0; f < nf; ++f) vec = vec && chans[f] % 16 == 0;
  const int unit = vec ? 16 : 1;
  auto tiles = [&](int rpt) {
    int t = 0;
    for (int f = 0; f < nf; ++f) {
      const int n = ceil_div(rows, (long)row_lanes(chans[f], unit) * rpt);
      t = t > n ? t : n;
    }
    return t;
  };
  int rpt = quant ? RPT : 2 * RPT;
  while (rpt > 1 && (long)tiles(rpt) * n_slots * nf < TARGET_BLOCKS) rpt /= 2;
  return {unit, rpt, tiles(rpt)};
}

// The lanes of a warp that hold one row's consecutive 16-channel units: a
// group of `size` lanes (32, or all of a row's units when 32 is a multiple
// of them) swaps its bf16 results by shuffles so that each store is one
// whole 16-byte word a lane, a warp's stores contiguous.  size 0: each lane
// stores its own 32 bytes.
struct Group {
  unsigned mask;
  int size, idx;                     // lanes, this lane's place in the group
};

// One unit of a row: 16 channels by 16-byte words, or one channel.
template <typename T, bool QUANT, int UNIT>
struct Unit {
  using In = std::conditional_t<QUANT, int8_t, T>;
  static constexpr int WORDS = UNIT == 16 ? 16 * (int)sizeof(In) / 16 : 1;
  uint4 w[WORDS];
  In x;

  __device__ __forceinline__ void load(const In* p) {
    if constexpr (UNIT == 1) {
      x = *p;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) w[i] = __ldg((const uint4*)p + i);
    }
  }

  __device__ __forceinline__ void store(T* o, const float (&s)[UNIT], const Group& g) const {
    if constexpr (!QUANT) {
      if constexpr (UNIT == 1) {
        *o = x;
      } else {
#pragma unroll
        for (int i = 0; i < WORDS; ++i) ((uint4*)o)[i] = w[i];
      }
    } else if constexpr (UNIT == 1) {
      *o = from_f32<T>(__fmul_rn((float)x, s[0]));
    } else {
      const unsigned b[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
      float y[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        y[j] = __fmul_rn((float)(int)(signed char)(b[j / 4] >> (8 * (j % 4))), s[j]);
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ((float4*)o)[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
      } else {
        unsigned p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = (unsigned)__bfloat16_as_ushort(from_f32<T>(y[2 * i]))
                 | (unsigned)__bfloat16_as_ushort(from_f32<T>(y[2 * i + 1])) << 16;
        if (g.size == 0) {
          ((uint4*)o)[0] = make_uint4(p[0], p[1], p[2], p[3]);
          ((uint4*)o)[1] = make_uint4(p[4], p[5], p[6], p[7]);
          return;
        }
        // the group's 16-byte words in order: word v is half v & 1 of the
        // unit of lane v >> 1; store k takes words [k * size, (k + 1) * size)
        uint4* seg = (uint4*)(o - g.idx * 16);
        const int first = (threadIdx.x & 31) - g.idx;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int v = k * g.size + g.idx, src = first + (v >> 1);
          unsigned q[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) q[i] = __shfl_sync(g.mask, p[i], src);
          seg[v] = v & 1 ? make_uint4(q[4], q[5], q[6], q[7]) : make_uint4(q[0], q[1], q[2], q[3]);
        }
      }
    }
  }
};

// A thread's rows [r, r_hi) of one unit column, a chunk at a time: row r
// of chunk ch = r / cs is read at in + r * C and written at
// out + ch * out_cs + (r - ch * cs) * C.  `in`, `out`, `sc` point at the
// column in row 0 (sc: chunk 0's scales).
template <typename T, bool QUANT, int UNIT>
__device__ __forceinline__ void unit_rows(const typename Unit<T, QUANT, UNIT>::In* in, T* out,
                                          const float* sc, int C, int r, int r_hi, int cs,
                                          long long out_cs, const Group& g) {
  constexpr int U = QUANT ? 4 : 2;
  while (r < r_hi) {
    const int ch = r / cs;
    const int end = min(r_hi, (ch + 1) * cs);
    T* o = out + ch * (out_cs - (long long)cs * C);   // this chunk's rows at o + r * C
    float s[UNIT];
    if constexpr (QUANT) {
      const float* p = sc + (long)ch * C;
      if constexpr (UNIT == 16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = __ldg((const float4*)p + i);
          s[4 * i] = v.x;
          s[4 * i + 1] = v.y;
          s[4 * i + 2] = v.z;
          s[4 * i + 3] = v.w;
        }
      } else {
        s[0] = __ldg(p);
      }
    }
    for (; r + U <= end; r += U) {
      Unit<T, QUANT, UNIT> v[U];
#pragma unroll
      for (int k = 0; k < U; ++k) v[k].load(in + (long)(r + k) * C);
#pragma unroll
      for (int k = 0; k < U; ++k) v[k].store(o + (long)(r + k) * C, s, g);
    }
    for (; r < end; ++r) {
      Unit<T, QUANT, UNIT> v;
      v.load(in + (long)r * C);
      v.store(o + (long)r * C, s, g);
    }
  }
}

// The body of a launch of grid (tiles, n_slots, nf) x NT threads.
template <typename T, bool QUANT, int UNIT>
__device__ __forceinline__ void dequant_rows(const RowsArgs& a) {
  using In = typename Unit<T, QUANT, UNIT>::In;
  const int f = blockIdx.z;
  const int C = a.chans[f];
  const int G = C / UNIT;                       // units a row
  const int cl_n = G < NT ? G : NT, rl_n = NT / cl_n;
  const int cl = threadIdx.x % cl_n, rl = threadIdx.x / cl_n;
  const int r_lo = ((int)blockIdx.x * rl_n + rl) * a.rpt;
  const int r_hi = min(a.rows, r_lo + a.rpt);
  if (rl >= rl_n || r_lo >= r_hi) return;
  Group g = {0u, 0, 0};
  if (UNIT == 16 && (G % 32 == 0 || 32 % G == 0)) {
    g.size = G % 32 == 0 ? 32 : G;
    g.idx = cl % g.size;
    g.mask = g.size == 32 ? 0xffffffffu
                          : ((1u << g.size) - 1) << ((threadIdx.x & 31) - g.idx);
  }
  const long long slot = a.slot_lo + (long long)blockIdx.y;
  const In* in = static_cast<const In*>(a.in[f]) + slot * a.in_ss[f];
  T* out = static_cast<T*>(a.out[f]) + slot * a.out_ss[f];
  for (int u = cl; u < G; u += cl_n)
    unit_rows<T, QUANT, UNIT>(in + u * UNIT, out + u * UNIT,
                              QUANT ? a.scales[f] + u * UNIT : nullptr, C, r_lo, r_hi, a.cs,
                              a.out_cs[f], g);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// K::get<T, QUANT, UNIT>() is the including file's __global__ instance of
// dequant_rows (each file names its own, so a trace tells them apart).
template <class K, typename T, bool QUANT>
int launch_as(const RowsArgs& a, int nf, int n_slots, const RowsPlan& p, cudaStream_t s) {
  const void* kern = p.unit == 16 ? (const void*)K::template get<T, QUANT, 16>()
                                  : (const void*)K::template get<T, QUANT, 1>();
  void* args[] = {(void*)&a};
  const cudaError_t e = cudaLaunchKernel(kern, dim3(p.tiles, n_slots, nf), dim3(NT), args, 0, s);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Plans and launches `a` (rpt is set here) over n_slots slots and nf
// fields: int8 rows with scales (QUANT), else raw rows of the output type.
template <class K, bool QUANT>
int launch(RowsArgs a, int nf, int n_slots, int dtype, cudaStream_t s) {
  if (nf < 1 || nf > MAXF || n_slots < 1 || n_slots > 65535 || a.rows < 1 || a.cs < 1)
    return (int)cudaErrorInvalidValue;
  const long esz = dtype == DT_BF16 ? 2 : 4, in_esz = QUANT ? 1 : esz;
  bool aligned = true;
  for (int f = 0; f < nf; ++f) {
    if (a.chans[f] < 1) return (int)cudaErrorInvalidValue;
    aligned = aligned && aligned16(a.out[f]) && aligned16(a.in[f])
              && (!QUANT || aligned16(a.scales[f])) && a.out_ss[f] * esz % 16 == 0
              && a.out_cs[f] * esz % 16 == 0
              && a.in_ss[f] * in_esz % 16 == 0;
  }
  const RowsPlan p = rows_plan(a.chans, nf, a.rows, n_slots, aligned, QUANT);
  a.rpt = p.rpt;
  if (dtype == DT_BF16) return launch_as<K, __nv_bfloat16, QUANT>(a, nf, n_slots, p, s);
  if (dtype == DT_F32) return launch_as<K, float, QUANT>(a, nf, n_slots, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace dqr
