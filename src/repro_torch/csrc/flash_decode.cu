// GQA decode attention: one query token per row over a kpos-addressed cache.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py `flash_decode` (body
// `_kernel`), the Pallas TPU kernel of every decode step.  Slot j is
// visible iff 0 <= kpos[j] <= q_pos (and kpos[j] > q_pos - window when
// window > 0), so ring-buffer caches work exactly.  Online softmax in f32.
//
// What bounds it on the H100: decode reads the whole cache once for one
// token (2 FLOP per byte read), so device-memory bandwidth bounds it: a
// 4096-slot cache at Hkv 8, Dh 128 is 16.8 MB per layer, 5 us at 3.35 TB/s;
// RecurrentGemma's 2048-slot window at Hkv 1, Dh 256 is 2.1 MB, 0.6 us.
// Design: one block per (query head, batch row) and Dh threads, thread d
// owning output column d; the G heads of a KV head read the same K/V
// tiles, which L2 serves after the first.  (The first version held all G
// heads of a KV head in one block: 8 blocks at qwen3-8b's shapes and one
// block at RecurrentGemma's single KV head, which cannot use the card.)
// K/V are staged through shared memory in tiles of 64 (Dh 128) or 32
// (Dh 256) slots with 16-byte global loads; each slot's score is a dot
// product split over Dh/BK threads, reduced by warp shuffles, with the row
// stride chosen so those threads hit distinct banks.  A tile with no
// visible slot is skipped.  Known limit, left for later work: Hq * B
// blocks walk the cache in sequence; a split over S with a second
// combining pass (split-K) is the fix.
#include "common.cuh"

namespace {

template <int DH, int BK>
__global__ void __launch_bounds__(DH)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ kpos,
                    __nv_bfloat16* __restrict__ out,
                    int S, int Hq, int Hkv, int G, int q_pos, int window,
                    float scale) {
  constexpr int NT = DH;         // threads; thread d owns output column d
  constexpr int TPP = NT / BK;   // threads sharing one slot's dot product
  // row stride in 32-bit words = DH/2 + TPP: the TPP threads of each of
  // the 32/TPP slots a warp scores at once read distinct banks
  constexpr int KSTR = DH + 2 * TPP;
  __shared__ __align__(16) __nv_bfloat16 Ks[BK][KSTR];
  __shared__ __align__(16) __nv_bfloat16 Vs[BK][KSTR];
  __shared__ float qs[DH];
  __shared__ float sc[BK];
  __shared__ float m_s, l_s, c_s;
  __shared__ int kps[BK];

  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / G;

  qs[tid] = __bfloat162float(q[((size_t)b * Hq + h) * DH + tid]);
  if (tid == 0) {
    m_s = -INFINITY;
    l_s = 0.f;
  }
  float acc = 0.f;

  const size_t kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* kb = k + ((size_t)b * S) * kv_row + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + ((size_t)b * S) * kv_row + (size_t)kvh * DH;
  const int j_own = tid / TPP, part = tid % TPP;

  for (int k0 = 0; k0 < S; k0 += BK) {
    int alive = 0;
    if (tid < BK) {
      const int j = k0 + tid;
      const int kp = j < S ? kpos[j] : -1;
      kps[tid] = kp;
      alive = kp >= 0 && kp <= q_pos && (window <= 0 || kp > q_pos - window);
    }
    if (!__syncthreads_or(alive)) continue;

    // stage the tile: 16-byte global loads, 32-bit shared stores (the
    // padded rows are 4-byte aligned)
    for (int idx = tid; idx < BK * (DH / 8); idx += NT) {
      const int r = idx / (DH / 8), c8 = (idx % (DH / 8)) * 8;
      const int j = k0 + r;
      uint4 kw = make_uint4(0, 0, 0, 0), vw = make_uint4(0, 0, 0, 0);
      if (j < S) {
        kw = *reinterpret_cast<const uint4*>(kb + (size_t)j * kv_row + c8);
        vw = *reinterpret_cast<const uint4*>(vb + (size_t)j * kv_row + c8);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(&Ks[r][c8]);
      uint32_t* vd = reinterpret_cast<uint32_t*>(&Vs[r][c8]);
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
    }
    __syncthreads();

    // score of slot j_own: TPP threads each take every TPP-th pair of
    // columns, then a shuffle sum over the TPP neighbouring lanes
    float dot = 0.f;
#pragma unroll 8
    for (int w = part; w < DH / 2; w += TPP) {
      const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(&Ks[j_own][2 * w]);
      dot = fmaf(qs[2 * w], __low2float(kk), dot);
      dot = fmaf(qs[2 * w + 1], __high2float(kk), dot);
    }
#pragma unroll
    for (int off = 1; off < TPP; off <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (part == 0) {
      const int kp = kps[j_own];
      const bool ok = kp >= 0 && kp <= q_pos && (window <= 0 || kp > q_pos - window);
      sc[j_own] = ok ? dot * scale : -INFINITY;
    }
    __syncthreads();

    // tile max, probabilities, running sum (warp 0)
    if (tid < 32) {
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, sc[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s;
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float x = sc[j];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        sc[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        m_s = m_new;
        l_s = l_s * c + sum;
        c_s = c;
      }
    }
    __syncthreads();

    // acc = acc * corr + sum_j p[j] V[j][tid]
    float a = acc * c_s;
#pragma unroll 8
    for (int j = 0; j < BK; ++j) a = fmaf(sc[j], __bfloat162float(Vs[j][tid]), a);
    acc = a;
    __syncthreads();  // tile consumed before the next one overwrites it
  }

  out[((size_t)b * Hq + h) * DH + tid] = __float2bfloat16_rn(acc / fmaxf(l_s, 1e-30f));
}

template <int DH, int BK>
int launch(const void* q, const void* k, const void* v, const void* kpos,
           void* out, int B, int S, int Hq, int Hkv, int q_pos, int window,
           float scale, cudaStream_t stream) {
  dim3 grid(Hq, B);
  flash_decode_kernel<DH, BK><<<grid, DH, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)kpos, (__nv_bfloat16*)out, S, Hq,
      Hkv, Hq / Hkv, q_pos, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Dh), k/v (B, S, Hkv, Dh) bf16, kpos (S,) int32 ->
// out (B, Hq, Dh) bf16.  Dh is 128 or 256; Hq must be a multiple of Hkv.
extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kpos, void* out, int B, int S,
                                 int Hq, int Hkv, int Dh, int q_pos,
                                 int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return launch<128, 64>(q, k, v, kpos, out, B, S, Hq, Hkv, q_pos, window,
                           scale, st);
  if (Dh == 256)
    return launch<256, 32>(q, k, v, kpos, out, B, S, Hq, Hkv, q_pos, window,
                           scale, st);
  return (int)cudaErrorInvalidValue;
}
