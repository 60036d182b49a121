// RG-LRU gated linear recurrence  h_t = exp(log_a_t) * h_{t-1} + b_t  (f32).
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py `rglru_scan` (body
// `_kernel`), the Pallas TPU kernel that steps the recurrence over time
// blocks with the running state in VMEM scratch.  Same interface:
// (log_a, b, h0) -> (h for every step, h_last).
//
// What bounds it on the H100: every element is read twice (log_a, b) and
// written once (h), so device-memory bytes bound it: (1, 256, 2560) is
// 7.9 MB, 2.35 us at 3.35 TB/s.  The recurrence is sequential in time and
// independent across (batch row, channel).  exp(log_a_t) does not depend on
// h, so only a multiply then an add lie on the chain from one step to the
// next, about 8 cycles: 256 steps take about 1.1 us.  Both kernels stay in
// strict time order with IEEE unfused arithmetic (expf, __fmul_rn, then
// __fadd_rn), so h is bit-exact with the plain PyTorch version that steps
// `a[:, t] * h + b[:, t]`, and one call over S steps equals chained calls.
// What the kernels need is many bytes in flight and the exponentials off
// the chain.  kernels/rglru_scan `rglru_plan` picks the kernel:
//
// 1. `rglru_scan_step_kernel` (S = 1, decode): elementwise over (B, W),
//    four channels a thread by 16-byte loads and stores (one channel where
//    W % 4 != 0 or a pointer is not 16-byte aligned); h and h_last are
//    written as two tensors.
// 2. `rglru_scan_tile_kernel` (S >= 2): grid (ceil(W / C), B).  A block owns
//    a strip of C channels of one batch row and walks time in tiles of T
//    steps.  Its warps split the work, handing tiles on by mbarriers:
//    - warp 1 fills a ring of STAGES shared-memory stages with the log_a
//      and b tiles as they lie in device memory (a row a step): one thread
//      asks the Tensor Memory Accelerator for each tile, a box of a 3-D
//      tensor map (C channels, T steps, one batch row) that completes on
//      the stage's mbarrier, so STAGES tiles are in flight at once and the
//      box's bounds mask the ragged last strip and tile;
//    - four warps take an arrived tile, free its stage for the next fill,
//      and write expf(log_a) and b transposed (a row a channel) into one of
//      two chain stages;
//    - warp 0 runs the chain, a lane a channel: 16-byte loads give it four
//      steps of a and of b, and a 16-byte store puts four steps of h into
//      one of two output tiles (a row a channel), so shared memory sees one
//      instruction in four a step; the chain lanes write h_last;
//    - warps 4 and 5, a storer for each output tile, send a finished tile
//      to h by coalesced 16-byte stores (four channels of a step a lane)
//      while the chain moves on.  Each storer has two tiles' time: one
//      storer for both tiles held the chain back.
//    Warp w issues on the SM's scheduler w % 4: the chain shares its
//    scheduler only with a storer.  The last time tile and the last strip
//    (W % C != 0) are masked.  Where W % 4 != 0 or a pointer is not 16-byte
//    aligned, an instance whose producer copies 4 bytes a lane by cp.async,
//    and whose storers store 4 bytes a lane, takes the call.
//    Designs measured and dropped (`chip_smoke.py --rglru-sweep`, PERF.md):
//    filling the ring by one bulk copy (cp.async.bulk) a row and storing h
//    by one bulk store a row, 2.5 times slower; 16-byte cp.async from one
//    warp, slower to issue than the tensor copies; the chain storing h to
//    device memory itself, which stalls it; a chain reading a step of a and
//    of b from rows of the tile as it lies in device memory.
#include <cuda.h>   // CUtensorMap and the types of its encoder

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int STEP_NT = 64;  // threads a block of the one-step kernel
constexpr int OUTB = 2;      // output tiles of the tiled kernel

// grid (ceil(n / (VEC * STEP_NT))), n = B * W (a multiple of VEC)
template <int VEC>
__global__ void __launch_bounds__(STEP_NT)
rglru_scan_step_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       float* __restrict__ h_last, int n) {
  const int i = (blockIdx.x * STEP_NT + threadIdx.x) * VEC;
  if (i >= n) return;
  if constexpr (VEC == 4) {
    const float4 la = __ldg((const float4*)(log_a + i));
    const float4 bb = __ldg((const float4*)(b + i));
    const float4 hp = __ldg((const float4*)(h0 + i));
    float4 o;
    o.x = __fadd_rn(__fmul_rn(expf(la.x), hp.x), bb.x);
    o.y = __fadd_rn(__fmul_rn(expf(la.y), hp.y), bb.y);
    o.z = __fadd_rn(__fmul_rn(expf(la.z), hp.z), bb.z);
    o.w = __fadd_rn(__fmul_rn(expf(la.w), hp.w), bb.w);
    *(float4*)(h + i) = o;
    *(float4*)(h_last + i) = o;
  } else {
    const float o = __fadd_rn(__fmul_rn(expf(log_a[i]), h0[i]), b[i]);
    h[i] = o;
    h_last[i] = o;
  }
}

// A tile block's eight warps: the chain (0), the producer (1), four
// transposing tiles and taking exponentials (2, 3, 6, 7) and a storer for
// each output tile (4, 5).  Each warp arrives once on a barrier, by its lane
// 0 after __syncwarp; the producer's lane 0 arrives with the bytes its
// tensor copies bring, or, with 4-byte copies, each lane as its own land.
constexpr int TILE_NT = 256;
constexpr int EXP_WARPS = 4;
constexpr int CSTAGES = 2;   // chain stages (transposed a and b)

// a transposed row (a channel's T steps), padded so that the chain's and
// the storers' accesses of neighbouring channels fall in distinct banks
__host__ __device__ constexpr int trow(int T) { return T + 4; }

// Dynamic shared memory of a tile block: 2 * STAGES + 2 * CSTAGES + 2 * OUTB
// mbarriers, then at a 128-byte boundary STAGES ring stages of (log_a tile,
// b tile), T x C f32 each; CSTAGES chain stages of (a, b) and OUTB output
// tiles, C x trow(T) f32 each.  Mirrored by kernels/rglru_scan `_smem_bytes`.
__host__ __device__ constexpr long tile_data_offset(int stages) {
  return (8L * (2 * stages + 2 * CSTAGES + 2 * OUTB) + 127) / 128 * 128;
}

__host__ __device__ constexpr long tile_smem_bytes(int C, int T, int stages) {
  return tile_data_offset(stages) + 4L * (2L * stages * T * C +
                                          (2L * CSTAGES + OUTB) * C * trow(T));
}

// grid (ceil(W / C), B), block TILE_NT.  VEC 4 (W % 4 == 0 and 16-byte
// aligned pointers): tiles come by tensor maps tm_a, tm_b of log_a and b,
// boxes (C, T, 1), and h leaves by 16-byte stores; VEC 1: 4-byte copies and
// stores, the maps unused.
template <int C, int T, int STAGES, int VEC>
__global__ void __launch_bounds__(TILE_NT, 2)
rglru_scan_tile_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h,
                       float* __restrict__ h_last, int S, int W,
                       const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b) {
  static_assert(OUTB == 2, "a storer warp for each output tile: warps 4 and 5");
  static_assert(T % 4 == 0 && C % 16 == 0, "whole 16-byte units");
  constexpr int TC = T * C;
  constexpr int RS = trow(T);
  constexpr int CT = C * RS;                // a transposed tile
  constexpr int UPR = C / VEC;              // stores a row of an output tile
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = (uint64_t*)smem;         // a ring stage's tile has landed
  uint64_t* rempty = full + STAGES;         // and is transposed: refill it
  uint64_t* exped = rempty + STAGES;        // a chain stage holds exp(log_a), b
  uint64_t* empty = exped + CSTAGES;        // the chain is done with it
  uint64_t* ofull = empty + CSTAGES;        // an output tile is written
  uint64_t* oempty = ofull + OUTB;          // and stored
  float* ring = (float*)(smem + tile_data_offset(STAGES));   // stage s: log_a, then b
  float* cring = ring + 2 * STAGES * TC;    // chain stage: a, then b, transposed
  float* outs = cring + 2 * CSTAGES * CT;   // output tiles, transposed

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * C, row = blockIdx.y;
  const int cw = min(C, W - w0);            // channels of this strip
  const int nt = (S + T - 1) / T;           // time tiles
  const size_t base = (size_t)row * S * W + w0;   // element (row, 0, w0)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], VEC == 4 ? 1 : 32);
      mbar_init(&rempty[s], EXP_WARPS);
    }
    for (int s = 0; s < CSTAGES; ++s) {
      mbar_init(&exped[s], EXP_WARPS);
      mbar_init(&empty[s], 1);
    }
    for (int o = 0; o < OUTB; ++o) {
      mbar_init(&ofull[o], 1);
      mbar_init(&oempty[o], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // tile k uses ring stage k % STAGES, chain stage k % CSTAGES and output
  // tile k % OUTB: each barrier completes one phase a use, so the k-th use
  // of a resource of n waits on parity (k / n) & 1

  if (warp == 1) {
    // the ring's producer
    for (int k = 0; k < nt; ++k) {
      const int s = k % STAGES, t0 = k * T;
      if (k >= STAGES) mbar_wait(&rempty[s], (k / STAGES - 1) & 1);
      float* a_s = ring + 2 * s * TC;
      float* b_s = a_s + TC;
      if constexpr (VEC == 4) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2u * TC * 4);
          tma_load_3d(a_s, &tm_a, w0, t0, row, &full[s]);
          tma_load_3d(b_s, &tm_b, w0, t0, row, &full[s]);
        }
      } else {
        const int rows = min(T, S - t0);
        const float* la = log_a + base + (size_t)t0 * W;
        const float* bg = b + base + (size_t)t0 * W;
#pragma unroll 4
        for (int i = lane; i < rows * C; i += 32) {
          const int r = i / C, c = i % C;
          if (c < cw) {
            cp_async4(a_s + r * C + c, la + (size_t)r * W + c, true);
            cp_async4(b_s + r * C + c, bg + (size_t)r * W + c, true);
          }
        }
        cp_async_mbar_arrive(&full[s]);
      }
    }
  } else if (warp == 4 || warp == 5) {
    // a storer: output tile o holds tiles o, o + OUTB, ...; each goes to h,
    // a step's channels a row
    const int o = warp - 4;
    const float* os = outs + o * CT;
    for (int k = o; k < nt; k += OUTB) {
      const int t0 = k * T, rows = min(T, S - t0);
      mbar_wait(&ofull[o], (k / OUTB) & 1);
      float* hg = h + base + (size_t)t0 * W;
#pragma unroll 4
      for (int i = lane; i < rows * UPR; i += 32) {
        const int r = i / UPR, c = i % UPR * VEC;
        if (c < cw) {
          if constexpr (VEC == 4)
            *(float4*)(hg + (size_t)r * W + c) =
                make_float4(os[c * RS + r], os[(c + 1) * RS + r], os[(c + 2) * RS + r],
                            os[(c + 3) * RS + r]);
          else
            hg[(size_t)r * W + c] = os[c * RS + r];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&oempty[o]);
    }
  } else if (warp != 0) {
    // exponentials of each arrived tile, written with b into a chain stage,
    // a row a channel (columns past the strip's channels and steps past the
    // last tile's rows are stale and never read)
    const int e = ((warp & 3) - 2 + 2 * (warp >> 2)) * 32 + lane;   // 0 .. 127
    for (int k = 0; k < nt; ++k) {
      const int s = k % STAGES, cs = k % CSTAGES, rows = min(T, S - k * T);
      mbar_wait(&full[s], (k / STAGES) & 1);
      if (k >= CSTAGES) mbar_wait(&empty[cs], (k / CSTAGES - 1) & 1);
      const float4* la4 = (const float4*)(ring + 2 * s * TC);
      const float4* b4 = la4 + TC / 4;
      float* at = cring + 2 * cs * CT;
      float* bt = at + CT;
      for (int i = e; i < rows * C / 4; i += 32 * EXP_WARPS) {
        const int t = i / (C / 4), c = i % (C / 4) * 4;
        const float4 x = la4[i], y = b4[i];
        at[c * RS + t] = expf(x.x);
        at[(c + 1) * RS + t] = expf(x.y);
        at[(c + 2) * RS + t] = expf(x.z);
        at[(c + 3) * RS + t] = expf(x.w);
        bt[c * RS + t] = y.x;
        bt[(c + 1) * RS + t] = y.y;
        bt[(c + 2) * RS + t] = y.z;
        bt[(c + 3) * RS + t] = y.w;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&rempty[s]);   // the ring stage may be refilled
        mbar_arrive(&exped[cs]);   // the chain stage is ready
      }
    }
  } else {
    // the chain: lane l holds channels l, l + 32, ... of the strip
    constexpr int CPL = C > 32 ? C / 32 : 1;   // chains a lane
    constexpr int PF = 2;                      // four-step groups loaded ahead
    const bool on = lane < C;
    const size_t hrow = (size_t)row * W + w0;
    float hv[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      hv[j] = on && c < cw ? h0[hrow + c] : 0.f;
    }
    for (int k = 0; k < nt; ++k) {
      const int cs = k % CSTAGES, o = k % OUTB, rows = min(T, S - k * T);
      const float* at = cring + 2 * cs * CT;
      const float* bt = at + CT;
      float* os = outs + o * CT;
      if (k >= OUTB) mbar_wait(&oempty[o], (k / OUTB - 1) & 1);   // tile k - OUTB stored
      mbar_wait(&exped[cs], (k / CSTAGES) & 1);
      if (on && rows == T) {
        // a whole tile, four steps a group; the next PF groups' operands
        // load while a group runs
        float4 x[PF + 1][CPL], y[PF + 1][CPL];
        auto load = [&](int q) {   // group q into slot q % (PF + 1)
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            x[q % (PF + 1)][j] = *(const float4*)(at + (lane + 32 * j) * RS + 4 * q);
            y[q % (PF + 1)][j] = *(const float4*)(bt + (lane + 32 * j) * RS + 4 * q);
          }
        };
#pragma unroll
        for (int q = 0; q < PF; ++q) load(q);
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
          if (q + PF < T / 4) load(q + PF);
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const float4 u = x[q % (PF + 1)][j], v = y[q % (PF + 1)][j];
            float4 r;
            hv[j] = r.x = __fadd_rn(__fmul_rn(u.x, hv[j]), v.x);
            hv[j] = r.y = __fadd_rn(__fmul_rn(u.y, hv[j]), v.y);
            hv[j] = r.z = __fadd_rn(__fmul_rn(u.z, hv[j]), v.z);
            hv[j] = r.w = __fadd_rn(__fmul_rn(u.w, hv[j]), v.w);
            *(float4*)(os + (lane + 32 * j) * RS + 4 * q) = r;
          }
        }
      } else if (on) {
        // the ragged last tile
        for (int t = 0; t < rows; ++t)
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = lane + 32 * j;
            hv[j] = __fadd_rn(__fmul_rn(at[c * RS + t], hv[j]), bt[c * RS + t]);
            os[c * RS + t] = hv[j];
          }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[cs]);   // the chain stage may be rewritten
        mbar_arrive(&ofull[o]);    // the output tile may be stored
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (on && c < cw) h_last[hrow + c] = hv[j];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's entry
// point query, so the library needs no link to libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// x (B, S, W) f32 as a 3-D tensor map (W, S, B innermost first) whose box is
// C channels by T steps of one batch row; 0 or a cudaError_t
int tile_map(CUtensorMap* m, const float* x, int B, int S, int W, int C, int T) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)C, (cuuint32_t)T, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)x, dims, strides, box,
                        unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int C, int T, int STAGES, int VEC>
int launch_tile(const float* log_a, const float* b, const float* h0, float* h,
                float* h_last, int B, int S, int W, cudaStream_t stream) {
  auto kernel = rglru_scan_tile_kernel<C, T, STAGES, VEC>;
  constexpr long smem = tile_smem_bytes(C, T, STAGES);
  static_assert(smem <= 232448, "a block may opt into 232,448 bytes at most");
  static bool granted = false;   // one attribute call per instantiation
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  CUtensorMap tm_a = {}, tm_b = {};
  if (VEC == 4) {
    int e = tile_map(&tm_a, log_a, B, S, W, C, T);
    if (e == 0) e = tile_map(&tm_b, b, B, S, W, C, T);
    if (e != 0) return e;
  }
  dim3 grid(ceil_div(W, C), B);
  kernel<<<grid, TILE_NT, smem, stream>>>(log_a, b, h0, h, h_last, S, W, tm_a, tm_b);
  return (int)cudaGetLastError();
}

}  // namespace

// log_a, b (B, S, W) f32, h0 (B, W) f32 -> h (B, S, W) f32, h_last (B, W)
// f32 by the tiled kernel: strips of C channels, tiles of T steps, a ring of
// `stages`, copies and stores of `vec` floats (4 or 1).  The plan comes from
// kernels/rglru_scan `rglru_plan`.
extern "C" int rglru_scan_f32(const void* log_a, const void* b, const void* h0, void* h,
                              void* h_last, int B, int S, int W, int C, int T,
                              int stages, int vec, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (W % 4 || ((uintptr_t)log_a | (uintptr_t)b | (uintptr_t)h) % 16))
    return (int)cudaErrorInvalidValue;
  const float *la_ = (const float*)log_a, *b_ = (const float*)b, *h0_ = (const float*)h0;
  float *h_ = (float*)h, *hl_ = (float*)h_last;
  cudaStream_t s = (cudaStream_t)stream;
#define RGLRU_TILE(c, t, st, v)                                                    \
  if (C == c && T == t && stages == st && vec == v)                                \
    return launch_tile<c, t, st, v>(la_, b_, h0_, h_, hl_, B, S, W, s);
  // TILE_VARIANTS of kernels/rglru_scan, by 16-byte copies; TILE by 4-byte
  RGLRU_TILE(16, 32, 2, 4) RGLRU_TILE(16, 32, 4, 4)
  RGLRU_TILE(16, 64, 2, 4) RGLRU_TILE(16, 64, 4, 4)
  RGLRU_TILE(32, 32, 2, 4) RGLRU_TILE(32, 32, 4, 4)
  RGLRU_TILE(32, 64, 2, 4) RGLRU_TILE(32, 64, 4, 4)
  RGLRU_TILE(64, 32, 2, 4) RGLRU_TILE(64, 32, 4, 4)
  RGLRU_TILE(64, 64, 2, 4)
  RGLRU_TILE(16, 32, 4, 1)
#undef RGLRU_TILE
  return (int)cudaErrorInvalidValue;
}

// the one-step kernel: log_a, b (B, 1, W), h0 (B, W) -> h (B, 1, W), h_last
// (B, W), n = B * W elements, `vec` 4 (16-byte units) or 1
extern "C" int rglru_scan_step_f32(const void* log_a, const void* b, const void* h0,
                                   void* h, void* h_last, int n, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    if (n % 4 || ((uintptr_t)log_a | (uintptr_t)b | (uintptr_t)h0 | (uintptr_t)h |
                  (uintptr_t)h_last) % 16)
      return (int)cudaErrorInvalidValue;
    rglru_scan_step_kernel<4><<<ceil_div(n, 4 * STEP_NT), STEP_NT, 0, s>>>(
        (const float*)log_a, (const float*)b, (const float*)h0, (float*)h,
        (float*)h_last, n);
  } else if (vec == 1) {
    rglru_scan_step_kernel<1><<<ceil_div(n, STEP_NT), STEP_NT, 0, s>>>(
        (const float*)log_a, (const float*)b, (const float*)h0, (float*)h,
        (float*)h_last, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
