// RWKV-6 wkv recurrence, per (batch, head) with a (Dh x Dh) f32 state S:
//
//     y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py `wkv6` (body `_kernel`),
// the Pallas TPU kernel whose grid walks time blocks in order with S in VMEM
// scratch.  Same interface: (r, k, v, w, u, s0) -> (y, s_last), all f32.
//
// What bounds it on the H100: every input is read once and y and S written
// once, against about five operations per state element per step, so
// device-memory bandwidth bounds it: (1, 256, 64, 64) moves 23.1 MB, 6.9 us
// at 3.35 TB/s; one step (decode) moves 2.2 MB of state, 0.66 us.  What
// holds a kernel back is the dependence in time, not bytes: a step-by-step
// walk pays a step's latency (shared loads, a reduction, a barrier) S times.
//
// Two kernels:
//
// * wkv6_step_kernel, S = 1 (decode).  A thread holds 4 consecutive columns
//   of one state row as a float4, so S is read and written fully coalesced;
//   a block owns 16 columns of one (batch, head): the grid is (4, H, B), 256
//   blocks at H = 64.  y sums its rows by shuffles in a warp, then across
//   the block's 8 warps in shared memory; one warp computes the bonus
//   r . (u * k).  The state update is IEEE and unfused (__fmul_rn, __fmul_rn,
//   __fadd_rn), the order the plain PyTorch version's elementwise
//   `s * w + k * v` takes, so s_last agrees with it bit for bit.
//
// * wkv6_chunk_kernel, S >= 2.  The sequence is walked in chunks of C steps
//   from the call's first step.  For a chunk with state S_in, every decay
//   factor is a product of decays in [0, 1] -- no logarithm, no exponential,
//   so w = 0 and strong decay need no special case:
//       A[t] = prod_{c0<=m<t} w_m,  A_end = A[last] w_last,
//       D[t,j] = prod_{j<m<t} w_m,  E[j] = prod_{j<m<=last} w_m,
//       y_t = (r_t A_t)^T S_in + sum_{j<t} P[t,j] v_j + P[t,t] v_t,
//       P[t,j] = sum_i r_t[i] D[t,j,i] k_j[i],  P[t,t] = r_t . (u * k_t),
//       S_out = diag(A_end) S_in + sum_j (k_j E_j) v_j^T.
//   Columns of S evolve on their own, so a block of 256 threads owns NJ
//   columns of one (batch, head): grid (64 / NJ, H, B), 128 blocks at
//   H = 64 and NJ = 32.  One barrier a chunk: after it, every lane runs
//   the previous chunk's chain (y and S_out, from its registers of S), then
//   this chunk's work that does not depend on S_in -- warps 0-3 the score
//   matrix P, two columns a lane-group, by running products along t; warps
//   4-7 A and E by walks along t.  r, k, w (whole rows) and v (the block's
//   columns) are staged with cp.async PD chunks ahead.  A ragged last chunk
//   runs only its valid steps.  All f32 on the CUDA cores.
//   By count, shared-memory traffic holds it back, not the FP32 pipe: a
//   lane holds a 4-row x CPT-column tile of S, so each value it loads from
//   shared memory feeds CPT (y) or about 1.4 (S_out and P v) multiply-adds,
//   and y needs a sum over 16 lanes (30 shuffles a chunk).  Tensor cores
//   would take the two products off the shared-memory path.
//
// Head sizes: each kernel is a template on the head size Dh and is built for
// 64 (rwkv6-7b; the numbers above) and 32 (the reduced config the CPU tests
// and a reduced training run use), the chunked kernel with 4 Dh threads a
// block (at 32: one variant, 16 steps and all 32 columns a block).
//
// Invariance: a chunk's arithmetic depends only on its own inputs and
// S_in, and chunks start at the call's first step, so one pass equals
// chained calls whose boundaries are multiples of C, bit for bit.
#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int SC = 16;           // state columns a block of the one-step kernel
constexpr int PD = 2;            // chunks the chunked kernel's copies run ahead

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& a, int q) {
  return q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
}

// ---------------------------------------------------------------------------
// One step (decode)
// ---------------------------------------------------------------------------

// head size DH; grid (DH / SC, H, B), block DH * SC / 4 threads; thread
// (row, cq) holds columns col0 + 4 cq .. + 3 of state row `row`
template <int DH>
__global__ void __launch_bounds__(DH * SC / 4)
wkv6_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_last, int H) {
  constexpr int SNT = DH * SC / 4;  // threads: one float4 of state each
  __shared__ __align__(16) float part[SNT / 32][SC];   // each warp's y over its 8 rows
  __shared__ float bonus_s;

  const int col0 = blockIdx.x * SC, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid / (SC / 4), cq = tid % (SC / 4);
  const size_t hb = ((size_t)b * H + h) * DH;                     // (b, 0, h, 0)
  const size_t si = hb * DH + (size_t)row * DH + col0 + 4 * cq;   // (b, h, row, col)

  const float4 s = ld4(s0 + si);
  const float rr = r[hb + row], kk = k[hb + row], ww = w[hb + row];
  const float4 vv = ld4(v + hb + col0 + 4 * cq);

  if (warp == 0) {   // the bonus r . (u * k), once a block
    float p = 0.f;
#pragma unroll
    for (int x = lane; x < DH; x += 32)
      p = fmaf(r[hb + x], __fmul_rn(u[(size_t)h * DH + x], k[hb + x]), p);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
    if (lane == 0) bonus_s = p;
  }

  float4 o;
  o.x = __fadd_rn(__fmul_rn(s.x, ww), __fmul_rn(kk, vv.x));
  o.y = __fadd_rn(__fmul_rn(s.y, ww), __fmul_rn(kk, vv.y));
  o.z = __fadd_rn(__fmul_rn(s.z, ww), __fmul_rn(kk, vv.z));
  o.w = __fadd_rn(__fmul_rn(s.w, ww), __fmul_rn(kk, vv.w));
  *reinterpret_cast<float4*>(s_last + si) = o;

  // y over this warp's 8 rows: lanes with the same cq differ in bits 2-4
  float4 p = make_float4(rr * s.x, rr * s.y, rr * s.z, rr * s.w);
#pragma unroll
  for (int m = 4; m <= 16; m <<= 1) {
    p.x += __shfl_xor_sync(0xffffffffu, p.x, m);
    p.y += __shfl_xor_sync(0xffffffffu, p.y, m);
    p.z += __shfl_xor_sync(0xffffffffu, p.z, m);
    p.w += __shfl_xor_sync(0xffffffffu, p.w, m);
  }
  if (lane < SC / 4) *reinterpret_cast<float4*>(&part[warp][4 * lane]) = p;
  __syncthreads();
  if (tid < SC) {
    float acc = 0.f;
#pragma unroll
    for (int wp = 0; wp < SNT / 32; ++wp) acc += part[wp][tid];
    y[hb + col0 + tid] = fmaf(bonus_s, v[hb + col0 + tid], acc);
  }
}

// ---------------------------------------------------------------------------
// Chunks of C steps, products of decays
// ---------------------------------------------------------------------------

// Sum part[0 .. V) over the L lanes of an aligned lane group (li: the lane's
// index in it), V >= L, and spread the sums over the group: lane li ends
// with the sums of t = li * V / L + q in part[q], q < V / L.  A fixed tree,
// so the sums are the same at every call.  One level a template instance: a
// loop over levels whose inner trip count halves each level is not unrolled
// fully, and its array then lives in local memory.
template <int V, int L, int N = V>   // N: the sums still spread over L lanes
__device__ __forceinline__ void reduce_scatter(float (&part)[V], int li) {
  static_assert(N >= L && L >= 1, "at least one sum a lane");
  if constexpr (L > 1) {
    constexpr int m = L / 2, half = N / 2;
    const bool upper = li & m;
#pragma unroll
    for (int q = 0; q < half; ++q) {
      const float send = upper ? part[q] : part[q + half];
      const float keep = upper ? part[q + half] : part[q];
      part[q] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    reduce_scatter<V, m, half>(part, li);
  }
}

// head size DH, C steps a chunk, NJ state columns a block, CPT state
// columns a lane; 4 DH threads a block
template <int DH, int C, int NJ, int CPT>
struct Chunk {
  static constexpr int NT = 4 * DH;          // threads a block
  static constexpr int IQ = NT / C;          // lanes sharing a score column pair
  static constexpr int IPT = DH / IQ;        // i a score lane sums over
  static constexpr int G = NT * CPT / NJ;    // lanes sharing a state column
  static constexpr int RPT = DH / G;         // state rows a lane holds
  static constexpr int YV = C * CPT / G;     // y a lane writes a chunk
  static constexpr int YT = YV / CPT;        // ... at this many steps
  static constexpr int SR = PD + 1;          // stages of the r, k, w ring
  static constexpr int SV = PD + 2;          // stages of the v ring
  static constexpr int PS = C + 1;           // padded row of P
  // shared memory, in floats
  static constexpr int RKW = 3 * C * DH;                 // r, k, w of a chunk
  static constexpr int OFF_V = SR * RKW;                 // [SV][C][NJ]
  static constexpr int OFF_RA = OFF_V + SV * C * NJ;     // [2][C][DH]
  static constexpr int OFF_KE = OFF_RA + 2 * C * DH;     // [2][C][DH]
  static constexpr int OFF_AEND = OFF_KE + 2 * C * DH;   // [2][DH]
  static constexpr int OFF_P = OFF_AEND + 2 * DH;        // [2][C][C + 1]
  static constexpr int OFF_ST = OFF_P + 2 * C * PS;      // [DH][NJ + 1]
  static constexpr int FLOATS = OFF_ST + DH * (NJ + 1);
  static constexpr size_t BYTES = (size_t)FLOATS * 4;
  static_assert(IQ >= 4 && IQ <= 16 && IPT % 4 == 0, "score lanes");
  static_assert(G <= 16 && RPT % 4 == 0 && YV % CPT == 0 && YT >= 1, "state lanes");
  static_assert(CPT == 1 || CPT == 2 || CPT == 4, "columns a lane");
  static_assert(64 % C == 0 && DH % NJ == 0 && NT / 2 == 2 * DH, "shapes");
  static_assert(BYTES <= 232448, "shared memory a block may have");
};

// grid (DH / NJ, H, B), block 4 DH threads, Chunk<...>::BYTES dynamic smem.
// Iteration it, after one barrier: chunk it - 1 on the chain (y, S_out),
// then chunk it's work that does not depend on S_in (A, E, P), while the
// copies of chunk it + PD are in flight.
template <int DH, int C, int NJ, int CPT>
__global__ void __launch_bounds__(4 * DH)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_last, int S, int H) {
  using L = Chunk<DH, C, NJ, CPT>;
  constexpr int NT = L::NT;
  extern __shared__ __align__(16) float smem[];
  float* const vs = smem + L::OFF_V;
  float* const rA = smem + L::OFF_RA;
  float* const kE = smem + L::OFF_KE;
  float* const aend = smem + L::OFF_AEND;
  float* const P = smem + L::OFF_P;
  float* const stS = smem + L::OFF_ST;

  const int col0 = blockIdx.x * NJ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t step = (size_t)H * DH;                   // between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;     // (b, 0, h, 0)
  const size_t sbase = ((size_t)b * H + h) * DH * DH;   // (b, h, 0, 0)
  const int nc = (S + C - 1) / C;

  auto stage = [&](int c) {   // chunk c's copies as one group (empty past the end)
    if (c < nc) {
      float* const dst = smem + (c % L::SR) * L::RKW;
      const int t0 = c * C;
      for (int q = tid; q < C * DH / 4; q += NT) {
        const int t = q / (DH / 4), x = q % (DH / 4);
        const bool ok = t0 + t < S;
        const size_t off = base + (size_t)(ok ? t0 + t : 0) * step + 4 * x;
        cp_async16(dst + t * DH + 4 * x, r + off, ok);
        cp_async16(dst + C * DH + t * DH + 4 * x, k + off, ok);
        cp_async16(dst + 2 * C * DH + t * DH + 4 * x, w + off, ok);
      }
      float* const vd = vs + (c % L::SV) * C * NJ;
      for (int q = tid; q < C * NJ / 4; q += NT) {
        const int t = q / (NJ / 4), x = q % (NJ / 4);
        const bool ok = t0 + t < S;
        cp_async16(vd + t * NJ + 4 * x,
                   v + base + (size_t)(ok ? t0 + t : 0) * step + col0 + 4 * x, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < PD; ++c) stage(c);

  // the state: lane g of the lanes sharing columns col .. col + CPT - 1
  // holds rows 4 g + 4 G m + e of them, st[row * CPT + c]; read (and at the
  // end written) through shared memory so device memory sees whole rows
  const int col = (warp * (32 / L::G) + lane / L::G) * CPT, g = lane % L::G;
  for (int q = tid; q < DH * NJ; q += NT)
    stS[(q / NJ) * (NJ + 1) + q % NJ] = s0[sbase + (size_t)(q / NJ) * DH + col0 + q % NJ];
  __syncthreads();
  float st[L::RPT * CPT];
#pragma unroll
  for (int m = 0; m < L::RPT / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        st[(4 * m + e) * CPT + c] = stS[(4 * g + 4 * L::G * m + e) * (NJ + 1) + col + c];

  // the scores (the first NT / 2 threads): columns j0 and C - 1 - j0, i in
  // {4 iq + 4 IQ m + e}; jw, the warp's first j0.  The masks bound j0 below
  // C / 2 for the compiler: without them the kernel took 110 registers
  // instead of 118 and 10% longer on the H100 (PERF.md).
  const int j0 = (tid & (NT / 2 - 1)) / L::IQ, j1 = C - 1 - j0, iq = tid % L::IQ;
  const int jw = (warp & 3) * (32 / L::IQ);
  float uu[L::IPT];
#pragma unroll
  for (int m = 0; m < L::IPT / 4; ++m) {
    const float4 a = ld4(u + (size_t)h * DH + 4 * iq + 4 * L::IQ * m);
#pragma unroll
    for (int e = 0; e < 4; ++e) uu[4 * m + e] = comp(a, e);
  }

  for (int it = 0; it <= nc; ++it) {
    cp_async_wait<PD - 1>();   // chunk it's copies
    __syncthreads();           // ... visible to all; iteration it - 1 done
    stage(it + PD);

    // chunk it - 1 on the chain: y = (r A)^T S_in + P v, then S_out
    if (it >= 1) {
      const int ch = it - 1, t0 = ch * C, n = min(C, S - t0);
      const float* const rAc = rA + (ch & 1) * C * DH;
      const float* const kEc = kE + (ch & 1) * C * DH;
      const float* const ae = aend + (ch & 1) * DH;
      const float* const Pc = P + (ch & 1) * C * L::PS;
      const float* const vc = vs + (ch % L::SV) * C * NJ;
      // (r A)^T S_in over this lane's rows: part[t * CPT + c]
      float part[C * CPT];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        float p[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) p[c] = 0.f;
#pragma unroll
        for (int m = 0; m < L::RPT / 4; ++m) {
          const float4 a = ld4(rAc + t * DH + 4 * g + 4 * L::G * m);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              p[c] = fmaf(comp(a, e), st[(4 * m + e) * CPT + c], p[c]);
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) part[t * CPT + c] = p[c];
      }
      // S_out = diag(A_end) S_in + sum_j (k_j E_j) v_j^T
#pragma unroll
      for (int m = 0; m < L::RPT / 4; ++m) {
        const float4 a = ld4(ae + 4 * g + 4 * L::G * m);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CPT; ++c) st[(4 * m + e) * CPT + c] *= comp(a, e);
      }
      // ... and P v for the steps this lane writes (P[t][j] = 0 for j > t)
      float pv[L::YV];
#pragma unroll
      for (int q = 0; q < L::YV; ++q) pv[q] = 0.f;
#pragma unroll
      for (int jj = 0; jj < C; ++jj) {
        if (jj < n) {
          float vj[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) vj[c] = vc[jj * NJ + col + c];
#pragma unroll
          for (int m = 0; m < L::RPT / 4; ++m) {
            const float4 a = ld4(kEc + jj * DH + 4 * g + 4 * L::G * m);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int c = 0; c < CPT; ++c)
                st[(4 * m + e) * CPT + c] = fmaf(comp(a, e), vj[c], st[(4 * m + e) * CPT + c]);
          }
#pragma unroll
          for (int q = 0; q < L::YT; ++q) {
            const float pj = Pc[(g * L::YT + q) * L::PS + jj];
#pragma unroll
            for (int c = 0; c < CPT; ++c) pv[q * CPT + c] = fmaf(pj, vj[c], pv[q * CPT + c]);
          }
        }
      }
      // sum over the G lanes: this lane keeps steps g * YT .. + YT - 1, all
      // CPT columns
      reduce_scatter<C * CPT, L::G>(part, g);
#pragma unroll
      for (int q = 0; q < L::YT; ++q) {
        const int t = g * L::YT + q;
        if (t < n) {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            y[base + (size_t)(t0 + t) * step + col0 + col + c] =
                part[q * CPT + c] + pv[q * CPT + c];
        }
      }
    }

    // chunk it's work that does not depend on S_in
    if (it < nc) {
      const int n = min(C, S - it * C);
      const float* const rs = smem + (it % L::SR) * L::RKW;
      const float* const ks = rs + C * DH;
      const float* const ws = ks + C * DH;
      if (tid >= NT / 2) {        // warps 4-7: A forward, E backward
        const int i = (tid - NT / 2) % DH;
        const bool fwd = tid < NT / 2 + DH;
        const float* const src = fwd ? rs : ks;
        float x[C], wv[C];
#pragma unroll
        for (int t = 0; t < C; ++t) {
          x[t] = src[t * DH + i];
          wv[t] = ws[t * DH + i];
        }
        if (fwd) {                // r A and A_end
          float a = 1.f;
#pragma unroll
          for (int t = 0; t < C; ++t) {
            if (t < n) {
              x[t] *= a;
              a *= wv[t];
            }
          }
          float* const dst = rA + (it & 1) * C * DH;
#pragma unroll
          for (int t = 0; t < C; ++t)
            if (t < n) dst[t * DH + i] = x[t];
          aend[(it & 1) * DH + i] = a;
        } else {                  // k E
          float e = 1.f;
#pragma unroll
          for (int t = C - 1; t >= 0; --t) {
            if (t < n) {
              x[t] *= e;
              e *= wv[t];
            }
          }
          float* const dst = kE + (it & 1) * C * DH;
#pragma unroll
          for (int t = 0; t < C; ++t)
            if (t < n) dst[t * DH + i] = x[t];
        }
      } else {                    // warps 0-3: P[t][j0] and P[t][j1]
        // D by running products along t, the bonus on the diagonal, 0
        // above it; a warp skips the t before its first j0
        float kk[2][L::IPT], uk[2][L::IPT], d[2][L::IPT], part[2 * C];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
          for (int m = 0; m < L::IPT / 4; ++m) {
            const float4 a = ld4(ks + (h2 ? j1 : j0) * DH + 4 * iq + 4 * L::IQ * m);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              kk[h2][4 * m + e] = comp(a, e);
              uk[h2][4 * m + e] = __fmul_rn(uu[4 * m + e], comp(a, e));
              d[h2][4 * m + e] = 1.f;
            }
          }
        }
#pragma unroll
        for (int t = 0; t < C; ++t) {
          float p[2] = {0.f, 0.f};
          if (t >= jw) {
#pragma unroll
            for (int m = 0; m < L::IPT / 4; ++m) {
              const float4 r4 = ld4(rs + t * DH + 4 * iq + 4 * L::IQ * m);
              const float4 w4 = ld4(ws + t * DH + 4 * iq + 4 * L::IQ * m);
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int jh = h2 ? j1 : j0;
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int x = 4 * m + e;
                  p[h2] = fmaf(comp(r4, e), t == jh ? uk[h2][x] : kk[h2][x] * d[h2][x], p[h2]);
                  if (t > jh) d[h2][x] *= comp(w4, e);
                }
              }
            }
            if (t < j0) p[0] = 0.f;
            if (t < j1) p[1] = 0.f;
          }
          part[2 * t] = p[0];
          part[2 * t + 1] = p[1];
        }
        // sum over the IQ lanes: lane iq keeps t = iq * C / IQ .., both j
        reduce_scatter<2 * C, L::IQ>(part, iq);
        float* const Pn = P + (it & 1) * C * L::PS;
#pragma unroll
        for (int q = 0; q < 2 * C / L::IQ; ++q) {
          const int idx = iq * (2 * C / L::IQ) + q;
          Pn[(idx / 2) * L::PS + ((idx & 1) ? j1 : j0)] = part[q];
        }
      }
    }
  }

  // s_last through shared memory (stS was last read before the loop)
#pragma unroll
  for (int m = 0; m < L::RPT / 4; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        stS[(4 * g + 4 * L::G * m + e) * (NJ + 1) + col + c] = st[(4 * m + e) * CPT + c];
  __syncthreads();
  for (int q = tid; q < DH * NJ; q += NT)
    s_last[sbase + (size_t)(q / NJ) * DH + col0 + q % NJ] = stS[(q / NJ) * (NJ + 1) + q % NJ];
}

template <int DH, int C, int NJ, int CPT>
int launch_chunk(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_last, int B,
                 int S, int H, cudaStream_t stream) {
  using L = Chunk<DH, C, NJ, CPT>;
  auto kernel = wkv6_chunk_kernel<DH, C, NJ, CPT>;
  static bool granted = false;   // one attribute call per instantiation
  if (!granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  dim3 grid(DH / NJ, H, B);
  kernel<<<grid, L::NT, L::BYTES, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_last, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w (B, 1, H, dh) f32, u (H, dh) f32, s0 (B, H, dh, dh) f32
//   -> y (B, 1, H, dh) f32, s_last (B, H, dh, dh) f32; dh 32 or 64
extern "C" int wkv6_step_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* y, void* s_last, int B, int H, int dh, void* stream) {
#define WKV6_STEP_CASE(DH_)                                                      \
  if (dh == DH_) {                                                               \
    wkv6_step_kernel<DH_><<<dim3(DH_ / SC, H, B), DH_ * SC / 4, 0, (cudaStream_t)stream>>>( \
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,      \
        (const float*)u, (const float*)s0, (float*)y, (float*)s_last, H);        \
    return (int)cudaGetLastError();                                              \
  }
  WKV6_STEP_CASE(64)
  WKV6_STEP_CASE(32)
#undef WKV6_STEP_CASE
  return (int)cudaErrorInvalidValue;
}

// r, k, v, w (B, S, H, dh) f32 with S >= 2, u (H, dh) f32, s0 (B, H, dh, dh)
//   f32 -> y (B, S, H, dh) f32, s_last (B, H, dh, dh) f32.  The variant:
//   `chunk` steps a chunk, `cols` state columns a block, `lane_cols` state
//   columns a lane (the Python wrapper's CHUNKED_VARIANTS for dh 64,
//   CHUNKED_32 for dh 32).
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_last,
                        int B, int S, int H, int dh, int chunk, int cols, int lane_cols,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define WKV6_CHUNK_CASE(DH_, C_, NJ_, CPT_)                                     \
  if (dh == DH_ && chunk == C_ && cols == NJ_ && lane_cols == CPT_)             \
    return launch_chunk<DH_, C_, NJ_, CPT_>(r, k, v, w, u, s0, y, s_last, B, S, H, st);
  WKV6_CHUNK_CASE(64, 16, 32, 2)
  WKV6_CHUNK_CASE(64, 16, 32, 1)
  WKV6_CHUNK_CASE(64, 16, 64, 2)
  WKV6_CHUNK_CASE(64, 16, 16, 1)
  WKV6_CHUNK_CASE(64, 32, 32, 2)
  WKV6_CHUNK_CASE(32, 16, 32, 2)
#undef WKV6_CHUNK_CASE
  return (int)cudaErrorInvalidValue;
}
