// GQA decode attention: one query token per row over a kpos-addressed cache.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py `flash_decode` (body
// `_kernel`), the Pallas TPU kernel of every decode step.  Slot j is
// visible iff 0 <= kpos[j] <= q_pos (and kpos[j] > q_pos - window when
// window > 0), so ring-buffer caches work exactly.  Online softmax in f32.
//
// What bounds it on the H100: decode reads the whole cache once for one
// token (2 FLOP per byte read), so device-memory bandwidth bounds it: a
// 4096-slot cache at Hkv 8, Dh 128 is 16.8 MB per layer, 5 us at 3.35 TB/s.
// Design: one block per (batch row, KV head) holds all G = Hq/Hkv query
// heads of the group, so every K/V tile is loaded from device memory once
// for the whole group (the GQA saving), staged through shared memory in
// 64-slot tiles with 16-byte-aligned rows padded against bank conflicts.
// A tile with no visible slot is skipped.  Known limit, left for later
// work: B*Hkv blocks (8 at batch 1) cannot fill 132 SMs; a split over S
// with a second combining pass (split-K) is the fix.
#include "common.cuh"

namespace {

constexpr int DH = 128;       // head dim the kernel is written for
constexpr int BK = 64;        // slots per tile
constexpr int KSTR = DH + 2;  // odd word stride: column reads hit 32 banks
constexpr int MAXG = 8;       // query heads per KV head the block can hold
constexpr int NT = 256;       // threads per block

// grid (Hkv, B), block NT threads
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ kpos,
                    __nv_bfloat16* __restrict__ out,
                    int S, int Hq, int Hkv, int G, int q_pos, int window,
                    float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK][KSTR];
  __shared__ float qs[MAXG][DH];
  __shared__ float sc[MAXG][BK];
  __shared__ float ms[MAXG], ls[MAXG], cs[MAXG];
  __shared__ int kps[BK];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int h0 = kvh * G;
  const int n_out = G * DH;   // outputs of the block, <= 4 per thread

  for (int i = tid; i < n_out; i += NT)
    qs[i / DH][i % DH] = __bfloat162float(q[((size_t)b * Hq + h0) * DH + i]);
  if (tid < G) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  float acc[MAXG * DH / NT];
#pragma unroll
  for (int i = 0; i < MAXG * DH / NT; ++i) acc[i] = 0.f;

  const size_t kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* kb = k + ((size_t)b * S) * kv_row + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + ((size_t)b * S) * kv_row + (size_t)kvh * DH;

  for (int k0 = 0; k0 < S; k0 += BK) {
    int alive = 0;
    for (int i = tid; i < BK; i += NT) {
      const int j = k0 + i;
      const int kp = j < S ? kpos[j] : -1;
      kps[i] = kp;
      alive |= kp >= 0 && kp <= q_pos && (window <= 0 || kp > q_pos - window);
    }
    if (!__syncthreads_or(alive)) continue;

    // stage the tile as 32-bit words (rows are 4-byte aligned)
    for (int idx = tid; idx < BK * (DH / 2); idx += NT) {
      const int r = idx / (DH / 2), c2 = (idx % (DH / 2)) * 2;
      const int j = k0 + r;
      uint32_t kw = 0u, vw = 0u;
      if (j < S) {
        kw = *reinterpret_cast<const uint32_t*>(kb + (size_t)j * kv_row + c2);
        vw = *reinterpret_cast<const uint32_t*>(vb + (size_t)j * kv_row + c2);
      }
      *reinterpret_cast<uint32_t*>(&Ks[r][c2]) = kw;
      *reinterpret_cast<uint32_t*>(&Vs[r][c2]) = vw;
    }
    __syncthreads();

    // scores: one (head, slot) pair per thread and pass
    for (int pr = tid; pr < G * BK; pr += NT) {
      const int g = pr / BK, j = pr % BK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; d += 2) {
        const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(&Ks[j][d]);
        dot = fmaf(qs[g][d], __low2float(kk), dot);
        dot = fmaf(qs[g][d + 1], __high2float(kk), dot);
      }
      const int kp = kps[j];
      const bool ok = kp >= 0 && kp <= q_pos && (window <= 0 || kp > q_pos - window);
      sc[g][j] = ok ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // per head: tile max, probabilities, running sum (warp g owns head g)
    if (warp < G) {
      const int g = warp;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sc[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float x = sc[g][j];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        sc[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        ms[g] = m_new;
        ls[g] = ls[g] * c + sum;
        cs[g] = c;
      }
    }
    __syncthreads();

    // acc[(g, d)] = acc * corr[g] + sum_j p[g][j] V[j][d]
#pragma unroll
    for (int i = 0; i < MAXG * DH / NT; ++i) {
      const int o = tid + i * NT;
      if (o < n_out) {
        const int g = o / DH, d = o % DH;
        float a = acc[i] * cs[g];
        for (int j = 0; j < BK; ++j) a = fmaf(sc[g][j], __bfloat162float(Vs[j][d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();  // tile consumed before the next one overwrites it
  }

#pragma unroll
  for (int i = 0; i < MAXG * DH / NT; ++i) {
    const int o = tid + i * NT;
    if (o < n_out) {
      const float l = fmaxf(ls[o / DH], 1e-30f);
      out[((size_t)b * Hq + h0) * DH + o] = __float2bfloat16_rn(acc[i] / l);
    }
  }
}

}  // namespace

// q (B, Hq, 128), k/v (B, S, Hkv, 128) bf16, kpos (S,) int32 ->
// out (B, Hq, 128) bf16.  G = Hq / Hkv <= 8.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kpos, void* out, int B, int S,
                                 int Hq, int Hkv, int q_pos, int window,
                                 float scale, void* stream) {
  dim3 grid(Hkv, B);
  flash_decode_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)kpos, (__nv_bfloat16*)out, S, Hq,
      Hkv, Hq / Hkv, q_pos, window, scale);
  return (int)cudaGetLastError();
}
