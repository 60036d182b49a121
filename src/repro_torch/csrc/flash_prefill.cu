// Causal GQA flash attention of a chunk of queries over a KV cache (bf16).
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py `flash_prefill`
// (body `_kernel`), the Pallas TPU kernel of the restoration recompute step
// and of suffix prefill.  Semantics follow the model's chunk attention
// (src/repro/models/attention.py `attention_chunk`): query i sits at
// absolute position q_offset + i and key slot j is visible iff
//     0 <= kpos[j] <= q_offset + i   (and kpos[j] > q_offset + i - window
//                                     when window > 0),
// so the TPU kernel's index mask is the case kpos[j] = j for j < kv_len,
// else -1.  Online softmax in f32; probabilities are rounded to bf16 before
// the P.V product, as the reference does.
//
// What bounds it on the H100: at qwen3-8b's shapes (a 256-token chunk over
// up to 4096 keys, Hq 32, Hkv 8, Dh 128) the work is ~17 GFLOP over ~21 MB,
// i.e. ~800 FLOP/byte, above the card's ~295 FLOP/byte ridge: the tensor
// cores bound it.  RecurrentGemma's (Hq 10, Hkv 1, Dh 256, a window of 2048
// slots) is ~2.7 GFLOP over ~3.4 MB, operation-bound as well.
// Design: both products run on the tensor cores with warp-level mma.sync
// m16n8k16 (bf16 in, f32 accumulate).  A block owns `hpb` query heads of
// one KV head (hpb = the largest divisor of G = Hq/Hkv that is <= 8, so
// G = 10 runs as two blocks of 5 heads) and 16*rt query rows; its warps
// (hpb heads x rt row tiles) share every K/V tile staged in shared memory.
// The kernel is a template on the head dim: at Dh 128 each warp keeps its
// Q fragments in registers (215 registers, no spills); at Dh 256 the O
// accumulators alone take 128 registers a thread, so Q is staged in shared
// memory and read one 16-column fragment at a time, and the key tile is
// halved to 32 keys to shrink the score registers.  A key tile none of
// whose slots is visible to any query of the block is skipped (decided from
// kpos, so the skip is exact for any cache layout).  Ragged Sq and S are
// masked in the kernel: no padding copies.  Simple first: no wgmma, no TMA,
// no software pipelining (later work).
#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_WARPS = 8;  // warps a block may have (__launch_bounds__)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_two(const __nv_bfloat16* lo,
                                           const __nv_bfloat16* hi) {
  uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

// c += a . b  for one 16x8x16 tile (A row-major 16x16, B col-major 16x8)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool visible(int kp, int qpos, int window) {
  return kp >= 0 && kp <= qpos && (window <= 0 || kp > qpos - window);
}

// Dynamic shared memory of one block: K and V tiles (BK x KSTR bf16), the
// tile's kpos (BK ints) and, when QSMEM, 16 Q rows for each warp.
template <int DH, int BK, bool QSMEM>
struct Smem {
  static constexpr int KSTR = DH + 8;  // padded row, bf16 elements
  static constexpr size_t kv = (size_t)BK * KSTR * 2;
  static constexpr size_t q_off = 2 * kv + BK * sizeof(int);
  static size_t bytes(int warps) {
    return q_off + (QSMEM ? (size_t)warps * 16 * KSTR * 2 : 0);
  }
};

// grid (ceil(Sq / rows), Hkv * G / hpb, B); block = hpb * rt warps; warp w
// serves query head kvh*G + grp*hpb + w%hpb and the 16-row tile w/hpb of
// the block's `rows` rows.
template <int DH, int BK, bool QSMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kpos,
                     __nv_bfloat16* __restrict__ out,
                     int Sq, int S, int Hq, int Hkv, int G, int hpb, int rows,
                     int q_offset, int window, float scale) {
  using SM = Smem<DH, BK, QSMEM>;
  constexpr int KSTR = SM::KSTR;
  extern __shared__ __align__(16) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16(*)[KSTR]>(smem);
  auto Vs = reinterpret_cast<__nv_bfloat16(*)[KSTR]>(smem + SM::kv);
  int* kps = reinterpret_cast<int*>(smem + 2 * SM::kv);

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int ngrp = G / hpb;
  const int kvh = blockIdx.y / ngrp, grp = blockIdx.y % ngrp;
  const int h = kvh * G + grp * hpb + warp % hpb;
  const int blk_row0 = blockIdx.x * rows;
  const int row0 = blk_row0 + (warp / hpb) * 16;
  const int r_lo = row0 + (lane >> 2), r_hi = r_lo + 8;
  const int quad = lane & 3;
  // query positions the block spans (for the exact tile skip)
  const int q_min = q_offset + blk_row0;
  const int q_max = q_offset + min(Sq, blk_row0 + rows) - 1;
  const float sl2 = scale * LOG2E;

  // Q of this warp's 16 rows, all of Dh: fragments in registers, or the
  // rows in this warp's own slice of shared memory
  const size_t q_row = (size_t)Hq * DH;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq) * q_row + (size_t)h * DH;
  uint32_t qa[QSMEM ? 1 : DH / 16][4];
  auto Qs = reinterpret_cast<__nv_bfloat16(*)[KSTR]>(smem + SM::q_off) + warp * 16;
  if constexpr (QSMEM) {
    for (int idx = lane; idx < 16 * (DH / 8); idx += 32) {
      const int r = idx / (DH / 8), c8 = (idx % (DH / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < Sq)
        val = *reinterpret_cast<const uint4*>(qb + (size_t)(row0 + r) * q_row + c8);
      *reinterpret_cast<uint4*>(&Qs[r][c8]) = val;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int d = kk * 16 + quad * 2;
      qa[kk][0] = r_lo < Sq ? ld_pair(qb + r_lo * q_row + d) : 0u;
      qa[kk][1] = r_hi < Sq ? ld_pair(qb + r_hi * q_row + d) : 0u;
      qa[kk][2] = r_lo < Sq ? ld_pair(qb + r_lo * q_row + d + 8) : 0u;
      qa[kk][3] = r_hi < Sq ? ld_pair(qb + r_hi * q_row + d + 8) : 0u;
    }
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 domain
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums

  const size_t kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* kb = k + ((size_t)b * S) * kv_row + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + ((size_t)b * S) * kv_row + (size_t)kvh * DH;

  for (int k0 = 0; k0 < S; k0 += BK) {
    // slot positions of the tile; skip it when no query of the block sees
    // any of its slots
    int alive = 0;
    for (int i = tid; i < BK; i += nthreads) {
      const int j = k0 + i;
      const int kp = j < S ? kpos[j] : -1;
      kps[i] = kp;
      alive |= kp >= 0 && kp <= q_max && (window <= 0 || kp > q_min - window);
    }
    if (!__syncthreads_or(alive)) continue;

    for (int idx = tid; idx < BK * (DH / 8); idx += nthreads) {
      const int r = idx / (DH / 8), c8 = (idx % (DH / 8)) * 8;
      const int j = k0 + r;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (j < S) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)j * kv_row + c8);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)j * kv_row + c8);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c8]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[r][c8]) = vv4;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x BK keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int d = kk * 16 + quad * 2;
      uint32_t qf[4];
      if constexpr (QSMEM) {
        const int rl = lane >> 2;
        qf[0] = ld_pair(&Qs[rl][d]);
        qf[1] = ld_pair(&Qs[rl + 8][d]);
        qf[2] = ld_pair(&Qs[rl][d + 8]);
        qf[3] = ld_pair(&Qs[rl + 8][d + 8]);
      } else {
        qf[0] = qa[kk][0]; qf[1] = qa[kk][1]; qf[2] = qa[kk][2]; qf[3] = qa[kk][3];
      }
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int key = nt * 8 + (lane >> 2);
        mma_bf16(s[nt], qf, ld_pair(&Ks[key][d]), ld_pair(&Ks[key][d + 8]));
      }
    }

    // mask, scale (log2 domain), row max over the tile
    const int qp_lo = q_offset + r_lo, qp_hi = q_offset + r_hi;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kps[nt * 8 + quad * 2 + (e & 1)];
        const bool hi = e >= 2;
        const bool ok = (hi ? r_hi : r_lo) < Sq && visible(kp, hi ? qp_hi : qp_lo, window);
        const float x = ok ? s[nt][e] * sl2 : -INFINITY;
        s[nt][e] = x;
        if (hi) mx_hi = fmaxf(mx_hi, x); else mx_lo = fmaxf(mx_lo, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // rows with nothing visible yet keep l = o = 0 (no -inf - -inf)
    const float c_lo = mn_lo == -INFINITY ? 1.f : exp2f(m_lo - mn_lo);
    const float c_hi = mn_hi == -INFINITY ? 1.f : exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const float x = s[nt][e];
        const float p = x == -INFINITY ? 0.f : exp2f(x - (hi ? mn_hi : mn_lo));
        s[nt][e] = p;
        if (hi) l_hi += p; else l_lo += p;
      }
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= c_lo; o[nd][1] *= c_lo;
      o[nd][2] *= c_hi; o[nd][3] *= c_hi;
    }

    // O += P V : P (16 x BK) from the S accumulators, V (BK x DH) staged
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
      pa[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
      pa[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
      pa[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
      const int key = t * 16 + quad * 2;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const int d = nd * 8 + (lane >> 2);
        mma_bf16(o[nd], pa, ld_two(&Vs[key][d], &Vs[key + 1][d]),
                 ld_two(&Vs[key + 8][d], &Vs[key + 9][d]));
      }
    }
    __syncthreads();  // tile consumed before the next one overwrites it
  }

  // each row's sum is spread over the 4 lanes of its quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-30f);
  l_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = out + ((size_t)b * Sq) * q_row + (size_t)h * DH;
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int d = nd * 8 + quad * 2;
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(ob + r_lo * q_row + d) =
          pack_bf16(o[nd][0] / l_lo, o[nd][1] / l_lo);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(ob + r_hi * q_row + d) =
          pack_bf16(o[nd][2] / l_hi, o[nd][3] / l_hi);
  }
}

template <int DH, int BK, bool QSMEM>
int launch(const void* q, const void* k, const void* v, const void* kpos,
           void* out, int B, int Sq, int S, int Hq, int Hkv, int q_offset,
           int window, float scale, cudaStream_t stream) {
  using SM = Smem<DH, BK, QSMEM>;
  auto kernel = flash_prefill_kernel<DH, BK, QSMEM>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SM::bytes(MAX_WARPS));
  if (attr != cudaSuccess) return (int)attr;
  const int G = Hq / Hkv;
  int hpb = 1;  // heads per block: the largest divisor of G up to 8
  for (int d = 1; d <= MAX_WARPS && d <= G; ++d)
    if (G % d == 0) hpb = d;
  const int rt = hpb >= 4 ? 1 : 4 / hpb;  // 16-row tiles per block
  const int rows = 16 * rt, warps = hpb * rt;
  dim3 grid(ceil_div(Sq, rows), Hkv * (G / hpb), B);
  kernel<<<grid, warps * 32, SM::bytes(warps), stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)kpos, (__nv_bfloat16*)out, Sq, S,
      Hq, Hkv, G, hpb, rows, q_offset, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, Dh), k/v (B, S, Hkv, Dh) bf16, kpos (S,) int32 ->
// out (B, Sq, Hq, Dh) bf16.  Dh is 128 or 256; Hq must be a multiple of Hkv.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* kpos, void* out, int B, int Sq,
                                  int S, int Hq, int Hkv, int Dh, int q_offset,
                                  int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh == 128)
    return launch<128, 64, false>(q, k, v, kpos, out, B, Sq, S, Hq, Hkv,
                                  q_offset, window, scale, st);
  if (Dh == 256)
    return launch<256, 32, true>(q, k, v, kpos, out, B, Sq, S, Hq, Hkv,
                                 q_offset, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
