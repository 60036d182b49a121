// GQA decode attention: one query token per row over a kpos-addressed cache.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py `flash_decode` (body
// `_kernel`), the Pallas TPU kernel of every decode step.  Slot j is
// visible iff 0 <= kpos[j] <= q_pos (and kpos[j] > q_pos - window when
// window > 0), so ring-buffer caches work exactly.  Online softmax in f32.
//
// What bounds it on the H100: decode reads the whole cache once for one
// token and does G = Hq / Hkv multiply-adds per K or V element read (4 at
// qwen3-8b, 10 at RecurrentGemma), far below the ~295 FLOP per byte where
// the tensor cores would become the limit: device-memory bandwidth bounds
// it.  A 4096-slot cache at Hkv 8, Dh 128 is 16.8 MB per layer, 5 us at
// 3.35 TB/s; RecurrentGemma's 2048-slot window at Hkv 1, Dh 256 is 2.1 MB,
// 0.6 us, less than a launch costs.  What it needs is bytes in flight
// across the whole card and short dependency chains, so the design is a
// split over the cache:
//
// 1. `flash_decode_split_kernel`, grid (n_split, Hkv, B).  Each block owns
//    one split of the cache (a whole number of 32-slot tiles; the last
//    split is ragged) for one KV head and batch row, and ALL its G query
//    heads, so every K/V byte is read from device memory once, as in the
//    TPU kernel.  The split plan (repro_torch.kernels.flash_decode.
//    _split_plan) aims at four blocks per SM.  K, V and kpos tiles are
//    staged through a two-stage ring in shared memory (35 KB at Dh 128, 68
//    KB at Dh 256, dynamic shared memory) with cp.async (16-byte copies for
//    K/V, 4-byte for kpos), the next tile's copies in flight while the
//    current one is used.  A tile with no visible slot is skipped (its
//    bytes were read).  A warp per query head, a lane per slot: lane j
//    computes slot j's whole f32 dot product (the query row is broadcast
//    from shared memory; K rows are padded by 16 bytes so the lanes' rows
//    fall in distinct banks), so no shuffle reduction is needed for a
//    score; the warp's online softmax takes 5 shuffles for the max and 5
//    for the sum, and lane l keeps Dh/32 output columns in registers.  The
//    only block barriers of a tile guard the ring.  A block writes, for
//    each head, its split's running max m, sum l and unnormalised
//    accumulator acc to f32 scratch — also for a split with no visible
//    slot (m = -inf, l = 0, acc = 0), so no memset is needed.  A block
//    has 4, 10 or 16 warps (G rounded up; the spare warps only copy);
//    past 16, the heads of a KV head are cut into groups of 16 along grid
//    y (not on the model paths: G is 4 and 10).
// 2. `flash_decode_combine_kernel`, one block per (query head, batch row,
//    64 columns): M = max_s m_s, out = sum_s e^{m_s-M} acc_s /
//    max(sum_s e^{m_s-M} l_s, 1e-30), rounded to bf16 once.  A split with
//    m = -inf adds 0 (never exp(-inf - -inf)).  A row where every split
//    has m = -inf (no visible slot at all) takes what the plain version's
//    finite -1e30 mask gives it: a uniform softmax over all S slots, the
//    mean of V over [0, S) in f32.  Only such rows read V here, so the
//    main path pays nothing for them.
// Left for later: one launch with a "last block combines" counter,
// mma.sync for the scores, thread block clusters.
#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int FD_TILE = 32;     // slots per tile, a lane each: TILE in the wrapper

constexpr int FD_STAGES = 2;    // depth of the cp.async ring

// the padded row of a staged K/V slot: 16 bytes more than Dh, so 8 lanes
// reading 8 rows hit 8 bank groups
template <int DH>
__host__ __device__ constexpr int fd_row() { return DH + 8; }

__device__ __forceinline__ bool visible(int kp, int q_pos, int window) {
  return kp >= 0 && kp <= q_pos && (window <= 0 || kp > q_pos - window);
}

// bf16 pairs of a 16-byte word as 8 floats (a bf16 is the top half of an f32)
__device__ __forceinline__ void unpack8(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(u[e] << 16);
    f[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
  }
}

// copy the tile of slots j0 .. j0 + FD_TILE - 1 into ring stage st; slots
// past the split (j >= j_hi) read as zeros and are masked by position
template <int DH, int NT>
__device__ __forceinline__ void copy_tile(
    __nv_bfloat16* Ks, __nv_bfloat16* Vs, int* kps, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, const int* kpos, size_t kv_row, int j0, int j_lo,
    int j_hi, int st, int tid) {
  constexpr int CH = DH / 8, ROW = fd_row<DH>();   // 16-byte chunks in a row
  constexpr int N = FD_TILE * CH;
#pragma unroll
  for (int i = 0; i < (N + NT - 1) / NT; ++i) {
    const int idx = tid + i * NT;
    if (N % NT != 0 && idx >= N) break;
    const int r = idx / CH, c = idx % CH, j = j0 + r;
    const bool in = j < j_hi;
    const size_t off = (size_t)(in ? j : j_lo) * kv_row + c * 8;
    cp_async16(Ks + (st * FD_TILE + r) * ROW + c * 8, kb + off, in);
    cp_async16(Vs + (st * FD_TILE + r) * ROW + c * 8, vb + off, in);
  }
  if (tid < FD_TILE)
    cp_async4(kps + st * FD_TILE + tid, kpos + min(j0 + tid, j_hi - 1), j0 + tid < j_hi);
}

// dynamic shared memory of one block: the K and V rings, the query rows in
// f32, each warp's probabilities of a tile, and the kpos ring
template <int DH, int GMAX>
constexpr size_t split_smem_bytes() {
  return 2 * sizeof(__nv_bfloat16) * FD_STAGES * FD_TILE * fd_row<DH>() +
         sizeof(float) * (GMAX * DH + GMAX * FD_TILE) +
         sizeof(int) * FD_STAGES * FD_TILE;
}

template <int DH, int GMAX>
__global__ void __launch_bounds__(32 * GMAX)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ kpos,
                          float* __restrict__ m_part, float* __restrict__ l_part,
                          float* __restrict__ acc_part, int S, int Hq, int Hkv,
                          int G, int n_groups, int q_pos, int window,
                          float scale, int n_split, int split_slots) {
  constexpr int NT = 32 * GMAX, BK = FD_TILE, STAGES = FD_STAGES;
  constexpr int ROW = fd_row<DH>();
  constexpr int DPL = DH / 32;       // output columns a lane owns: 4 or 8
  static_assert(BK == 32 && (DPL == 4 || DPL == 8), "DH must be 128 or 256");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);   // [STAGES][BK][ROW]
  __nv_bfloat16* Vs = Ks + STAGES * BK * ROW;                   // [STAGES][BK][ROW]
  float* qs = reinterpret_cast<float*>(Vs + STAGES * BK * ROW); // [GMAX][DH]
  float* ps = qs + GMAX * DH;                                   // [GMAX][BK]
  int* kps = reinterpret_cast<int*>(ps + GMAX * BK);            // [STAGES][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / n_groups, g0 = (blockIdx.y % n_groups) * GMAX;
  const int Gb = min(GMAX, G - g0);          // query heads of this block
  const int h0 = kvh * G + g0;               // its first query head
  const bool head = warp < Gb;               // this warp's head is h0 + warp
  const int j_lo = split * split_slots;
  const int j_hi = min(S, j_lo + split_slots);
  const int ntiles = (j_hi - j_lo + BK - 1) / BK;

  const size_t kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * DH;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      copy_tile<DH, NT>(Ks, Vs, kps, kb, vb, kpos, kv_row, j_lo + s * BK, j_lo, j_hi, s, tid);
    cp_async_commit();   // empty groups keep the wait count uniform
  }
  for (int i = tid; i < Gb * DH; i += NT)
    qs[i] = __bfloat162float(q[((size_t)b * Hq + h0) * DH + i]);

  // the warp's online softmax state, the same in every lane
  float m = -INFINITY, l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  const float* qh = qs + warp * DH;
  float* ph = ps + warp * BK;

  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    const int j = j_lo + t * BK + lane;      // this lane's slot
    // the stage tile t + STAGES - 1 lands in was consumed in iteration t - 1
    if (t + STAGES - 1 < ntiles)
      copy_tile<DH, NT>(Ks, Vs, kps, kb, vb, kpos, kv_row, j_lo + (t + STAGES - 1) * BK,
                         j_lo, j_hi, (t + STAGES - 1) % STAGES, tid);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();             // this thread's copies of tile t
    // kps[st][tid] is thread tid's own copy; the barrier publishes the rest
    const bool ok = tid < BK && j < j_hi && visible(kps[st * BK + tid], q_pos, window);
    if (!__syncthreads_or(ok)) continue;

    if (head) {
      // score of slot j: the whole dot product in this lane, in 4 chains
      const bool vis = j < j_hi && visible(kps[st * BK + lane], q_pos, window);
      const __nv_bfloat16* krow = Ks + (st * BK + lane) * ROW;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int c = 0; c < DH / 8; ++c) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(krow + c * 8), kf);
        const float4 qa = *reinterpret_cast<const float4*>(qh + c * 8);
        const float4 qb = *reinterpret_cast<const float4*>(qh + c * 8 + 4);
        d[0] = fmaf(qa.x, kf[0], d[0]);
        d[1] = fmaf(qa.y, kf[1], d[1]);
        d[2] = fmaf(qa.z, kf[2], d[2]);
        d[3] = fmaf(qa.w, kf[3], d[3]);
        d[0] = fmaf(qb.x, kf[4], d[0]);
        d[1] = fmaf(qb.y, kf[5], d[1]);
        d[2] = fmaf(qb.z, kf[6], d[2]);
        d[3] = fmaf(qb.w, kf[7], d[3]);
      }
      const float x = vis ? ((d[0] + d[1]) + (d[2] + d[3])) * scale : -INFINITY;

      // online softmax over the tile's 32 slots
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float p = x == -INFINITY ? 0.f : expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float cr = m_new == -INFINITY ? 1.f : expf(m - m_new);
      m = m_new;
      l = l * cr + sum;
      ph[lane] = p;
      __syncwarp();

      // acc = acc * cr + sum_j p[j] V[j][cols]; the p of four slots in one
      // broadcast 16-byte load, the lane's columns of a V row in one load
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] *= cr;
      const __nv_bfloat16* vcol = Vs + st * BK * ROW + lane * DPL;
#pragma unroll 2
      for (int j4 = 0; j4 < BK; j4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(ph + j4);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vf[8];
          if constexpr (DPL == 8) {
            unpack8(*reinterpret_cast<const uint4*>(vcol + (j4 + u) * ROW), vf);
          } else {
            const uint2 w = *reinterpret_cast<const uint2*>(vcol + (j4 + u) * ROW);
            unpack8(make_uint4(w.x, w.y, 0u, 0u), vf);
          }
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[e] = fmaf(pj[u], vf[e], acc[e]);
        }
      }
    }
    __syncthreads();  // tile (and ph) consumed before the stage is refilled
  }
  cp_async_wait<0>();  // no copy may outlive the block

  // partials of this split for the warp's head (m = -inf, l = 0, acc = 0
  // when no slot of the split was visible)
  if (head) {
    const size_t row = ((size_t)b * Hq + h0 + warp) * n_split + split;
    float4* dst = reinterpret_cast<float4*>(acc_part + row * DH + lane * DPL);
#pragma unroll
    for (int e = 0; e < DPL / 4; ++e)
      dst[e] = make_float4(acc[4 * e], acc[4 * e + 1], acc[4 * e + 2], acc[4 * e + 3]);
    if (lane == 0) {
      m_part[row] = m;
      l_part[row] = l;
    }
  }
}

// one block per (query head, batch row, 64 output columns): M = max_s m_s
// and the weights' sum, then 16 groups of threads sum every 16th split's
// acc over 4 columns each, and the groups meet in shared memory
constexpr int FC_THREADS = 256;
constexpr int FC_COLS = 64;

__global__ void __launch_bounds__(FC_THREADS)
flash_decode_combine_kernel(const float* __restrict__ m_part,
                            const float* __restrict__ l_part,
                            const float* __restrict__ acc_part,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int Hq, int DH,
                            int n_split, int S, int Hkv, int G) {
  constexpr int NT = FC_THREADS, NW = NT / 32;
  constexpr int C4 = FC_COLS / 4;  // float4 columns of the block
  constexpr int NG = NT / C4;      // split groups
  __shared__ float red[NW];
  __shared__ float4 sums[NG][C4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, col0 = blockIdx.z * FC_COLS;
  const size_t row0 = ((size_t)b * Hq + h) * n_split;

  float mx = -INFINITY;
  for (int s = tid; s < n_split; s += NT) mx = fmaxf(mx, m_part[row0 + s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) M = fmaxf(M, red[w]);
  __syncthreads();   // red is reused below

  const int grp = tid / C4, c = tid % C4;
  if (M == -INFINITY) {
    // no split saw a slot: groups of threads sum every NG-th row of V over
    // 4 columns each, and the groups meet in shared memory
    const size_t kv_row = (size_t)Hkv * DH;
    const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)(h / G) * DH + col0 + 4 * c;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = grp; j < S; j += NG) {
      const uint2 w = *reinterpret_cast<const uint2*>(vb + (size_t)j * kv_row);
      t.x += __uint_as_float(w.x << 16);
      t.y += __uint_as_float(w.x & 0xffff0000u);
      t.z += __uint_as_float(w.y << 16);
      t.w += __uint_as_float(w.y & 0xffff0000u);
    }
    sums[grp][c] = t;
    __syncthreads();
    if (tid < C4) {
      float4 u = sums[0][tid];
#pragma unroll
      for (int g = 1; g < NG; ++g) {
        const float4 x = sums[g][tid];
        u.x += x.x; u.y += x.y; u.z += x.z; u.w += x.w;
      }
      const float w = 1.f / (float)S;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
          out + ((size_t)b * Hq + h) * DH + col0 + 4 * tid);
      o[0] = __floats2bfloat162_rn(u.x * w, u.y * w);
      o[1] = __floats2bfloat162_rn(u.z * w, u.w * w);
    }
    return;
  }

  // a split with m = -inf (no visible slot) weighs 0: never exp(-inf - M)
  float den = 0.f;
  for (int s = tid; s < n_split; s += NT) {
    const float ms = m_part[row0 + s];
    den += ms == -INFINITY ? 0.f : expf(ms - M) * l_part[row0 + s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[warp] = den;

  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < n_split; s += NG) {
    const float ms = m_part[row0 + s];
    const float w = ms == -INFINITY ? 0.f : expf(ms - M);
    const float4 a = *reinterpret_cast<const float4*>(acc_part + (row0 + s) * DH + col0 + 4 * c);
    num.x = fmaf(w, a.x, num.x);
    num.y = fmaf(w, a.y, num.y);
    num.z = fmaf(w, a.z, num.z);
    num.w = fmaf(w, a.w, num.w);
  }
  sums[grp][c] = num;
  __syncthreads();
  if (tid < C4) {
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) L += red[w];
    L = fmaxf(L, 1e-30f);
    float4 t = sums[0][tid];
#pragma unroll
    for (int g = 1; g < NG; ++g) {
      const float4 u = sums[g][tid];
      t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + ((size_t)b * Hq + h) * DH + col0 + 4 * tid);
    o[0] = __floats2bfloat162_rn(t.x / L, t.y / L);
    o[1] = __floats2bfloat162_rn(t.z / L, t.w / L);
  }
}

template <int DH, int GMAX>
int launch(const void* q, const void* k, const void* v, const void* kpos,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int S, int Hq, int Hkv, int q_pos, int window, float scale,
           int n_split, int split_slots, cudaStream_t stream) {
  const int G = Hq / Hkv, n_groups = (G + GMAX - 1) / GMAX;
  constexpr size_t smem = split_smem_bytes<DH, GMAX>();
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<DH, GMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode_split_kernel<DH, GMAX><<<dim3(n_split, Hkv * n_groups, B), 32 * GMAX, smem,
                                        stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)kpos, m_part, l_part, acc_part, S, Hq, Hkv, G, n_groups,
      q_pos, window, scale, n_split, split_slots);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<<<dim3(Hq, B, DH / FC_COLS), FC_THREADS, 0, stream>>>(
      m_part, l_part, acc_part, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Hq, DH,
      n_split, S, Hkv, G);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Dh), k/v (B, S, Hkv, Dh) bf16, kpos (S,) int32 ->
// out (B, Hq, Dh) bf16, through f32 scratch m/l (B, Hq, n_split) and acc
// (B, Hq, n_split, Dh).  The cache is cut into n_split splits of
// split_slots slots (a multiple of FD_TILE; the last one ragged).  Dh is
// 128 or 256; Hq must be a multiple of Hkv.  Two kernels on `stream`.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kpos, void* out, void* m_part,
                                 void* l_part, void* acc_part, int B, int S,
                                 int Hq, int Hkv, int Dh, int q_pos, int window,
                                 int n_split, int split_slots, float scale,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (split_slots <= 0 || split_slots % FD_TILE || n_split <= 0 ||
      (long)(n_split - 1) * split_slots >= S || (long)n_split * split_slots < S)
    return (int)cudaErrorInvalidValue;
  float *m = (float*)m_part, *l = (float*)l_part, *acc = (float*)acc_part;
  // a block holds 4 (qwen3-8b), 10 (RecurrentGemma) or 16 query heads, a
  // warp each: the fewest that take all G; past 16 the heads of a KV head
  // are cut into groups of 16
  const int G = Hq / Hkv;
#define FD_ARGS q, k, v, kpos, out, m, l, acc, B, S, Hq, Hkv, q_pos, window, \
                scale, n_split, split_slots, st
#define FD_PICK(DH) (G <= 4 ? launch<DH, 4>(FD_ARGS) \
                     : G <= 10 ? launch<DH, 10>(FD_ARGS) : launch<DH, 16>(FD_ARGS))
  if (Dh == 128) return FD_PICK(128);
  if (Dh == 256) return FD_PICK(256);
#undef FD_PICK
#undef FD_ARGS
  return (int)cudaErrorInvalidValue;
}
