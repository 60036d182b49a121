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
// The divides are true IEEE divides and the rounding is half to even, as
// the reference; the file is built without --use_fast_math, so codes and
// scales are bit-identical to the plain PyTorch version.
//
// What bounds the quantizer on the H100: device-memory bytes, if the work
// spread over the card.  One 16-token chunk of all 36 layers' K is 1.18 MB
// of bf16 in and 0.59 MB of int8 out, 0.53 us at 3.35 TB/s.  But no element
// can be scaled before the maximum of its channel over every row is known.
// The TPU kernel makes that two pallas_calls, because a TPU grid cannot
// synchronise across programs.  Here it is ONE launch of thread-block
// clusters of N blocks (8 by default, 16 where the slab needs it):
//   1. load: block `rank` of a cluster owns rows [rank * rows_per, ...).  In
//      the slab branch one thread brings them into shared memory with up to
//      STAGES bulk copies (cp.async.bulk, each completing on its own
//      mbarrier), so x is read from device memory once;
//   2. reduce: each thread takes the |x| maxima of a 16-byte unit of
//      channels down its rows of each stage as it lands (bf16 pairs packed:
//      one max instruction a pair); lanes on the same channels combine by
//      shuffles, then shared-memory atomicMax on the bits of the
//      non-negative f32 maxima (order-free, so exact);
//   3. exchange: a cluster barrier, then every block reads all N ranks'
//      partial maxima through distributed shared memory (mapa +
//      ld.shared::cluster) and forms the same scales bit for bit;
//   4. quantize: the cluster's share of its rank's rows, from shared
//      memory, into int8.  A cluster barrier arrives after the exchange and
//      is waited on before exit, so no block leaves while another may still
//      read its maxima.
// Measured, the reduction and the quantize are instruction-bound on so few
// SMs (PERF.md, section 6).  So a launch holds up to CLUSTERS (kernels/kv_quant)
// clusters: each repeats steps 1-3 over every row -- the maxima are cheap,
// and the repeated reads hit L2 -- and quantizes 1/clusters of the rows.
// The clusters never meet, so the launch needs no grid-wide barrier.
// When the slab does not fit the block's shared memory (an f32 chunk, or
// more than 16 tokens of 36 layers), the same launch takes the re-read
// branch: both passes read the rows from device memory with 16-byte
// loads, the second finding them in L2.  A channel count whose rows are
// not a whole number of 16-byte units, or an unaligned pointer, takes the
// re-read branch one element at a time.  The host (kernels/kv_quant's
// `quant_plan`) picks N, the clusters, rows_per and the branch.
//
// Quantize arithmetic: two IEEE divides a channel (s, then inv = 1 / s),
// then y = x * inv, rounded half to even by adding 1.5 * 2^23 (the low byte
// of the sum's bits is the int8 code).  y is within 2^-15 of x / s correctly
// rounded (|x / s| <= 127.x, two roundings of 2^-24 each), so the two round
// to different integers only when y lies within that of a half-integer: a
// unit with such an element (an exact tie among them) is redone with
// __fdiv_rn, the clip and rintf, as the plain version computes it.
//
// Dequantize (kv_dequantize_kernel) is the decode routine of
// dequant_rows.cuh, shared with kv_restore.cu, writing a fresh buffer.  It
// takes a transfer run: (A, T, C) int8 staging views of every field, rows
// contiguous at any slot stride, with per-chunk scales (ceil(T / cs), C),
// in one launch, and writes each chunk as the contiguous (A, cs, C) block
// the pool copies; the 2D form above is one chunk (A = 1, T = R).
#include "async_copy.cuh"
#include "common.cuh"
#include "dequant_rows.cuh"

namespace {

constexpr int NT = 512;                   // threads a block
constexpr int STAGES = 4;                 // bulk copies (and mbarriers) a slab
constexpr float MAGIC = 12582912.0f;      // 1.5 * 2^23
constexpr float NEAR_TIE = 0.5f - 0x1p-14f;

// Dynamic shared memory: amax (C u32) | scale (C f32) | inv (C f32) |
// STAGES mbarriers | slab.  Mirrored by kernels/kv_quant `_smem_bytes`.
struct Layout {
  long scale, inv, mbar, slab, total;
};

__host__ __device__ inline Layout layout(int C, long slab_bytes) {
  Layout L;
  L.scale = 4L * C;
  L.inv = 8L * C;
  L.mbar = (12L * C + 7) / 8 * 8;
  L.slab = (L.mbar + 8L * STAGES + 127) / 128 * 128;
  L.total = L.slab + slab_bytes;
  return L;
}

// release / acquire at cluster scope (the defaults); not .aligned, since
// they follow loops whose trip counts differ between lanes
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// a u32 of rank `rank`'s shared memory at the address of `p` in this block's
__device__ __forceinline__ unsigned ld_rank(const unsigned* p, unsigned rank) {
  unsigned remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// VEC elements at p as f32: one 16-byte load (VEC = 16 / sizeof(T)), or one
// element (VEC = 1).  A global pointer is read through the read-only path.
template <typename T, int VEC, bool GLOBAL>
__device__ __forceinline__ void load_unit(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    uint4 u;
    if constexpr (GLOBAL)
      u = __ldg((const uint4*)p);
    else
      u = *(const uint4*)p;
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    if constexpr (sizeof(T) == 2) {      // bf16: the high half of an f32
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
    }
  }
}

// int8 codes of one unit, as the low bytes of their f32 bit patterns.  The
// fast path needs no clip: |x| <= absmax gives |y| <= 127 (1 + 2^-23).  A
// NaN (or an inf input, whose scale is inf) fails the test and takes the
// exact path, as the divide always did.
template <int VEC>
__device__ __forceinline__ void quant_unit(const float (&v)[VEC], const float (&s)[VEC],
                                           const float (&inv)[VEC], unsigned (&bits)[VEC]) {
  bool near = false;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float y = __fmul_rn(v[j], inv[j]);
    const float t = __fadd_rn(y, MAGIC);
    near |= !(fabsf(__fsub_rn(y, __fsub_rn(t, MAGIC))) <= NEAR_TIE);
    bits[j] = __float_as_uint(t);
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float y = fminf(fmaxf(rintf(__fdiv_rn(v[j], s[j])), -127.f), 127.f);
      bits[j] = __float_as_uint(__fadd_rn(y, MAGIC));
    }
  }
}

// Per-channel |x| maxima of one unit's channels down a thread's rows.  bf16
// keeps them packed: |x| is the bit pattern without its sign, and the max of
// two bf16 pairs is one instruction.
template <typename T, int VEC, bool GLOBAL>
struct AbsMax {
  float m[VEC];
  __device__ __forceinline__ AbsMax() {
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = 0.f;
  }
  __device__ __forceinline__ void add(const T* p) {
    float v[VEC];
    load_unit<T, VEC, GLOBAL>(p, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = fmaxf(m[j], fabsf(v[j]));
  }
  __device__ __forceinline__ void get(float (&out)[VEC]) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = m[j];
  }
};

template <bool GLOBAL>
struct AbsMax<__nv_bfloat16, 8, GLOBAL> {
  __nv_bfloat162 m[4];
  __device__ __forceinline__ AbsMax() {
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = __float2bfloat162_rn(0.f);
  }
  __device__ __forceinline__ void add(const __nv_bfloat16* p) {
    uint4 u;
    if constexpr (GLOBAL)
      u = __ldg((const uint4*)p);
    else
      u = *(const uint4*)p;
    const unsigned w[4] = {u.x & 0x7fff7fffu, u.y & 0x7fff7fffu, u.z & 0x7fff7fffu,
                           u.w & 0x7fff7fffu};
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = __hmax2(m[i], *(const __nv_bfloat162*)&w[i]);
  }
  __device__ __forceinline__ void get(float (&out)[8]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned b = *(const unsigned*)&m[i];
      out[2 * i] = __uint_as_float(b << 16);
      out[2 * i + 1] = __uint_as_float(b & 0xffff0000u);
    }
  }
};

template <int VEC>
__device__ __forceinline__ void store_unit(int8_t* q, const unsigned (&b)[VEC]) {
  if constexpr (VEC == 1) {
    *q = (int8_t)(b[0] & 0xff);
  } else {
    unsigned w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      w[i] = __byte_perm(__byte_perm(b[4 * i], b[4 * i + 1], 0x0040),
                         __byte_perm(b[4 * i + 2], b[4 * i + 3], 0x0040), 0x5410);
    if constexpr (VEC == 8)
      *(uint2*)q = make_uint2(w[0], w[1]);
    else
      *(unsigned*)q = w[0];
  }
}

template <typename T, int VEC, bool SLAB>
__global__ void __launch_bounds__(NT)
kv_quantize_cluster(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, int R, int C, int rows_per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C, SLAB ? (long)rows_per * C * sizeof(T) : 0);
  unsigned* amax_s = (unsigned*)smem;
  float* scale_s = (float*)(smem + L.scale);
  float* inv_s = (float*)(smem + L.inv);
  uint64_t* mbar = (uint64_t*)(smem + L.mbar);
  T* slab = (T*)(smem + L.slab);

  const unsigned rank = cluster_rank(), nrank = cluster_size();
  const unsigned k = blockIdx.x / nrank, nk = gridDim.x / nrank;  // cluster, clusters
  const long r0 = (long)rank * rows_per;
  const int rows = (int)max(0L, min((long)rows_per, (long)R - r0));
  const T* xs = x + r0 * C;                 // this rank's rows in device memory
  const int tid = threadIdx.x;
  const int units = C / VEC;                // units a row
  const int cl_n = min(units, NT), rl_n = NT / cl_n;
  const int cl = tid % cl_n, rl = tid / cl_n;
  const bool active = rl < rl_n;
  // stages and each cluster's share of the rows are whole groups of rl_n
  // rows, so a thread's rows in either are lo + rl, lo + rl + rl_n, ...
  auto groups = [&](int a, int b) { return ((a + b - 1) / b + rl_n - 1) / rl_n * rl_n; };
  const int stage_rows = max(rl_n, groups(rows, STAGES));
  // lanes cl_n apart hold the same channels when cl_n divides the warp
  const bool shuffle = cl_n < 32 && (32 % cl_n) == 0;

  for (int c = tid; c < C; c += NT) amax_s[c] = 0u;
  if (SLAB && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&mbar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (SLAB && tid == 0) {
    for (int s = 0, a = 0; a < rows; ++s, a += stage_rows) {
      const unsigned bytes = (unsigned)((long)(min(rows, a + stage_rows) - a) * C * sizeof(T));
      mbar_expect_tx(&mbar[s], bytes);
      bulk_load(slab + (long)a * C, xs + (long)a * C, bytes, &mbar[s]);
    }
  }

  // 1-2. this rank's per-channel |x| maxima (every cluster takes them all)
  const T* src = SLAB ? slab : xs;
  for (int u = cl; u < units; u += cl_n) {  // once for every lane when shuffling
    AbsMax<T, VEC, !SLAB> acc;
    if (active) {
      for (int s = 0, a = 0; a < rows; ++s, a += stage_rows) {
        if (SLAB) mbar_wait(&mbar[s], 0);
        const int b = min(rows, a + stage_rows);
#pragma unroll 2
        for (int rr = a + rl; rr < b; rr += rl_n) acc.add(src + (long)rr * C + u * VEC);
      }
    }
    float m[VEC];
    acc.get(m);
    if (shuffle) {
      for (int off = cl_n; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
    }
    if (active && (!shuffle || (tid & 31) < cl_n)) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) atomicMax(&amax_s[u * VEC + j], __float_as_uint(m[j]));
    }
  }

  // 3. every rank's maxima -> the scales (max is order-free: all ranks of
  // all clusters agree)
  cluster_arrive();
  cluster_wait();
  for (int c = tid; c < C; c += NT) {
    unsigned m = 0u;
    for (unsigned r = 0; r < nrank; ++r) m = max(m, ld_rank(&amax_s[c], r));
    const float s = __fdiv_rn(fmaxf(__uint_as_float(m), 1e-12f), 127.0f);
    scale_s[c] = s;
    inv_s[c] = __fdiv_rn(1.0f, s);
    if (rank == 0 && k == 0) scales[c] = s;
  }
  cluster_arrive();      // this block is done reading the other ranks
  __syncthreads();

  // 4. quantize this cluster's share of this rank's rows (in the slab branch
  // every stage landed before step 1 read it)
  const int share = groups(rows, nk);
  const int lo = min(rows, (int)k * share), hi = min(rows, lo + share);
  if (active) {
    for (int u = cl; u < units; u += cl_n) {
      float s[VEC], inv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] = scale_s[u * VEC + j];
        inv[j] = inv_s[u * VEC + j];
      }
#pragma unroll 2
      for (int rr = lo + rl; rr < hi; rr += rl_n) {
        float v[VEC];
        unsigned bits[VEC];
        load_unit<T, VEC, !SLAB>(src + (long)rr * C + u * VEC, v);
        quant_unit<VEC>(v, s, inv, bits);
        store_unit<VEC>(q + (r0 + rr) * C + u * VEC, bits);
      }
    }
  }
  cluster_wait();        // no rank exits while another may read its maxima
}

template <typename T, int VEC, bool SLAB>
int launch(const void* x, void* q, void* scales, int R, int C, int n, int clusters,
           int rows_per, cudaStream_t s) {
  auto kern = kv_quantize_cluster<T, VEC, SLAB>;
  const Layout L = layout(C, SLAB ? (long)rows_per * C * sizeof(T) : 0);
  static int optin = 0;  // once an instantiation: opt into the most shared
  if (optin == 0) {      // memory a block may use, and clusters past 8
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {
      optin = 0;
      return (int)e;
    }
  }
  if (L.total > optin) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)L.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, (const T*)x, (int8_t*)q, (float*)scales,
                                     R, C, rows_per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int quantize(const void* x, void* q, void* scales, int R, int C, int n, int clusters,
             int rows_per, int slab, int vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    if (((uintptr_t)x | (uintptr_t)q) % 16 || C % V) return (int)cudaErrorInvalidValue;
    return slab ? launch<T, V, true>(x, q, scales, R, C, n, clusters, rows_per, s)
                : launch<T, V, false>(x, q, scales, R, C, n, clusters, rows_per, s);
  }
  if (vec == 1 && !slab)
    return launch<T, 1, false>(x, q, scales, R, C, n, clusters, rows_per, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool QUANT, int UNIT>
__global__ void __launch_bounds__(dqr::NT, dqr::MIN_BLOCKS)
kv_dequantize_kernel(const dqr::RowsArgs a) {
  dqr::dequant_rows<T, QUANT, UNIT>(a);
}

struct DequantKernels {
  template <typename T, bool QUANT, int UNIT>
  static auto get() { return kv_dequantize_kernel<T, QUANT, UNIT>; }
};

}  // namespace

// x (R, C) of `dtype` -> q (R, C) int8, scales (C,) f32: one launch of
// `clusters` clusters of n blocks; rank r of each cluster reduces rows
// [r * rows_per, (r + 1) * rows_per) and quantizes that cluster's share of
// them.  `slab` keeps the rows in shared memory, `vec` is 16 / sizeof(dtype)
// (16-byte units) or 1.  The plan comes from kernels/kv_quant `quant_plan`.
extern "C" int kv_quantize(const void* x, void* q, void* scales, int R, int C, int dtype,
                           int n, int clusters, int rows_per, int slab, int vec,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || C < 1 || n < 1 || n > 16 || clusters < 1 || n * clusters > 1024
      || (long)n * rows_per < R)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return quantize<__nv_bfloat16>(x, q, scales, R, C, n, clusters, rows_per, slab, vec, s);
  if (dtype == DT_F32)
    return quantize<float>(x, q, scales, R, C, n, clusters, rows_per, slab, vec, s);
  return (int)cudaErrorInvalidValue;
}

// q[f] (A, T, chans[f]) int8, rows contiguous, slot stride q_ss[f]
// (elements); scales[f] (ceil(T / cs), chans[f]) f32 -> out[f]
// (ceil(T / cs), A, cs, chans[f]) of `dtype`, contiguous, chunk-major (rows
// past T of the last chunk are not written): every field of a run in one
// launch.  The single-chunk form (R, C) with (C,) scales is A = 1, T = R,
// cs = R.
extern "C" int kv_dequantize(int nf, void* const* outs, const void* const* q,
                             const void* const* scales, const int* chans,
                             const long long* q_ss, int A, int T, int cs, int dtype,
                             void* stream) {
  if (nf < 1 || nf > dqr::MAXF) return (int)cudaErrorInvalidValue;
  dqr::RowsArgs a = {};
  for (int f = 0; f < nf; ++f) {
    a.out[f] = outs[f];
    a.in[f] = q[f];
    a.scales[f] = static_cast<const float*>(scales[f]);
    a.out_ss[f] = (long long)cs * chans[f];             // chunk-major output
    a.out_cs[f] = (long long)A * cs * chans[f];
    a.in_ss[f] = q_ss[f];
    a.chans[f] = chans[f];
  }
  a.rows = T;
  a.cs = cs;
  return dqr::launch<DequantKernels, true>(a, nf, A, dtype, (cudaStream_t)stream);
}
