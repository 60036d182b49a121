// RWKV-6 wkv recurrence, backward.  Per (batch, head), with the forward
//
//     y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and G_t = dL/dS_t (G_{S-1} = ds_last, or 0 when s_last is unused), the
// gradient of (r, k, v, w, u, s0).
//
// The backward of: src/repro/kernels/rwkv6_scan/kernel.py `wkv6` (the
// reference trains through jax.grad of its plain scans, so there is no TPU
// backward kernel to translate; this is the gradient of the forward that
// csrc/wkv6.cu ports).  The Python wrapper's `wkv6_backward_plain` is this
// algorithm in plain torch.
//
// Chunk-parallel.  The sequence is cut into chunks of BC steps from the
// call's first step (c0 .. c0 + n - 1, n <= BC; a ragged last chunk runs
// only its valid steps).  For a chunk with state S_in before it and
// gradient G_out after it, every decay factor is a product of decays in
// [0, 1] -- nothing divides by w or takes its logarithm, so w = 0 and
// strong decay need no special case (per row i, elementwise):
//
//   A_t = prod_{c0<=q<t} w_q    B_t = prod_{t<q<=last} w_q    A_end = prod_q w_q
//   D[t,j] = prod_{j<q<t} w_q (j < t)      F[t,m] = D[m,t] (m > t)
//   SdY[i,t] = (S_in dy_t)[i]   GV[i,t] = (G_out v_t)[i]   VdY[j,t] = v_j . dy_t
//   dr_t = A_t SdY[.,t] + sum_{j<t} D[t,j] k_j VdY[j,t] + u k_t beta_t
//   dk_t = B_t GV[.,t]  + sum_{m>t} F[t,m] r_m VdY[t,m] + u r_t beta_t
//   dv_t = G_out^T (k_t B_t) + sum_{m>t} P[m,t] dy_m + (r_t . (u k_t)) dy_t,
//          P[m,t] = sum_i r_m[i] F[t,m,i] k_t[i]
//   dw_t = A_t B_t <G_out[i], S_in[i]> + A_t sum_{m>t} F[t,m] r_m SdY[.,m]
//        + B_t sum_{j<t} D[t,j] k_j GV[.,j] + sum_{j<t} D[t,j] k_j X[t,j],
//          X[t,j] = sum_{m>t} F[t,m] r_m VdY[j,m]
//   du  += sum_t r_t k_t beta_t            (beta_t = v_t . dy_t)
//   S_out = diag(A_end) S_in  + sum_j (k_j B_j) v_j^T
//   G_in  = diag(A_end) G_out + sum_t (r_t A_t) dy_t^T      (ds0 = chunk 0's)
//
// Three launches:
//
// * wkv6_bwd_state_kernel: the chunk boundaries.  Columns of S and of G
//   evolve on their own, so a block owns SNJ columns of one (batch, head)
//   and walks the chunks, a thread holding SCT columns of one row: blocks
//   x < DH / SNJ carry S forward from s0 (S_out above) and write S_in of
//   chunks 1 .. nc - 1; the others carry G back from ds_last (G_in above)
//   and write G_out of chunks 0 .. nc - 2, then ds0.  A thread walks its
//   own row's decays, so the only barrier a chunk is the one that hands
//   over the next chunk's rows, staged by cp.async SPD chunks ahead.  The
//   chunks run in sequence here, and every column block reads the chunk's
//   whole rows of k (or r) and w: 32 columns a block, 8 a thread, was the
//   fastest of the layouts tried on the H100 (16 or 64 columns, 4 to 16 a
//   thread).
// * wkv6_bwd_chunk_kernel: grid (chunks, H, B), every chunk at once.  A
//   block stages its chunk's rows, S_in and G_out (dynamic shared memory),
//   then (1) the products SdY, GV (a thread: one row i, BC / TQ steps),
//   VdY, <G_out[i], S_in[i]> and the bonus; (2) a thread per (row i, step
//   t) walks m up (F, B_t, the terms over m > t) and j down (D, A_t, the
//   terms over j < t; X[t,j] as a BC-wide dot product of F r with VdY's row
//   j), writes dr, dk, dw and k B, and sums its part of P over the warp's
//   32 rows by shuffles; (3) dv from G_out, k B and P, and du's part of the
//   chunk.  Every sum over columns or rows stays in the block.
// * wkv6_bwd_du_kernel: du, the chunks' parts summed over batch and chunks.
//
// Every sum is made in a fixed order and none with atomics, so two calls
// give the same bits.  All f32 on the CUDA cores.
//
// Chunks of 16 steps.  X's dot product and P's partial take BC registers a
// thread (F r, then k F r in place), and X costs BC a (t, j) pair, BC^3 / 2
// a row of a chunk, against each product's BC Dh: at 16 both stay small
// and a block's shared memory (73,920 bytes at Dh 64) lets three blocks
// share an SM, as its launch bounds say (at Dh 32, two: left to itself
// ptxas held that instance to 64 registers and spilled).  The price is the
// scratch: states (2, B, H, ceil(S / 16), dh, dh) f32 (only the slots above
// are written) and du_part (B, ceil(S / 16), H, dh) f32, 537 MB and 4.2 MB
// at (1, 4096, 64, 64), written once and read once.
//
// What bounds it on the H100: the function reads r, k, v, w, dy, s0 and
// writes dr, dk, dv, dw, ds0 once, against about 14 f32 operations a state
// element a step (the step-by-step walk's count): (1, 4096, 64, 64) moves
// 606 MB, 0.181 ms at 3.35 TB/s, and does 15.0 GFLOP, 0.224 ms at 67
// TFLOP/s -- the operations bound it.  This kernel does about 16 a state element a step
// (four products of BC Dh^2 multiply-adds a chunk, the terms over j and m,
// the state walks) and moves the scratch besides.  Built for head sizes 64
// and 32, as wkv6.cu.
#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int BC = 16;            // steps a chunk
constexpr int BNT = 256;          // threads a block of the chunk pass
constexpr int SNJ = 32;           // state columns a block of the state pass
constexpr int SCT = 8;            // of them a thread holds
constexpr int SPD = 2;            // chunks the state pass's copies run ahead

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float4& a) {
  *reinterpret_cast<float4*>(p) = a;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ float4 axpy4(float a, const float4& x, const float4& y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// Sum part[0 .. V) over the L lanes of an aligned lane group (li: the lane's
// index in it), V >= L, and spread the sums over the group: lane li ends
// with the sums of m = li * V / L + q in part[q], q < V / L.  A fixed tree,
// so the sums are the same at every call.
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

// ---------------------------------------------------------------------------
// State pass: S at chunk starts, G at chunk ends
// ---------------------------------------------------------------------------

// head size DH; grid (2 DH / SNJ, H, B), block DH SNJ / SCT threads; thread
// (i, cg) holds columns col0 + SCT cg .. + SCT - 1 of row i.  states (2, B,
// H, nc, DH, DH): [0] S_in of chunk c (c >= 1), [1] G_out of chunk c (c <=
// nc - 2).
template <int DH>
__global__ void __launch_bounds__(DH * SNJ / SCT)
wkv6_bwd_state_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ s0, const float* __restrict__ dy,
                      const float* __restrict__ ds_last, float* __restrict__ ds0,
                      float* __restrict__ states, int S, int H) {
  constexpr int NT = DH * SNJ / SCT;
  constexpr int NB = DH / SNJ;           // column blocks of a (batch, head)
  constexpr int NQ = SCT / 4;            // float4 a thread
  constexpr int STAGE = 2 * BC * DH + BC * SNJ;   // rows (k or r), w, columns (v or dy)
  __shared__ __align__(16) float ring[SPD + 1][STAGE];

  const bool grad = blockIdx.x >= NB;
  const int col0 = (blockIdx.x % NB) * SNJ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, i = tid / (SNJ / SCT), col = col0 + SCT * (tid % (SNJ / SCT));
  const size_t step = (size_t)H * DH;                   // between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;     // (b, 0, h, 0)
  const size_t sidx = ((size_t)b * H + h) * DH * DH + (size_t)i * DH + col;
  const int nc = (S + BC - 1) / BC;
  float* const slots = states + (grad ? (size_t)gridDim.z * H * nc * DH * DH : 0)
                       + ((size_t)b * H + h) * nc * DH * DH + (size_t)i * DH + col;
  const float* const rows = grad ? r : k;
  const float* const cols = grad ? dy : v;
  // S: chunks 0 .. nc - 2 forward (the last chunk's S_out is not needed);
  // G: chunks nc - 1 .. 0
  const int iters = grad ? nc : nc - 1;

  auto stage = [&](int it) {   // iteration it's rows as one group (empty past the end)
    if (it < iters) {
      const int t0 = (grad ? nc - 1 - it : it) * BC;
      float* const dst = ring[it % (SPD + 1)];
      for (int q = tid; q < BC * DH / 4; q += NT) {
        const int t = q / (DH / 4), x = 4 * (q % (DH / 4));
        const bool ok = t0 + t < S;
        const size_t off = base + (size_t)(ok ? t0 + t : 0) * step + x;
        cp_async16(dst + t * DH + x, rows + off, ok);
        cp_async16(dst + BC * DH + t * DH + x, w + off, ok);
      }
      for (int q = tid; q < BC * SNJ / 4; q += NT) {
        const int t = q / (SNJ / 4), x = 4 * (q % (SNJ / 4));
        const bool ok = t0 + t < S;
        cp_async16(dst + 2 * BC * DH + t * SNJ + x,
                   cols + base + (size_t)(ok ? t0 + t : 0) * step + col0 + x, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < SPD; ++p) stage(p);

  float4 st[NQ];
  const float* const init = grad ? ds_last : s0;
#pragma unroll
  for (int e = 0; e < NQ; ++e)
    st[e] = init != nullptr ? ld4(init + sidx + 4 * e) : make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<SPD - 1>();   // iteration it's copies
    __syncthreads();            // ... visible to all; iteration it - 1's reads done
    stage(it + SPD);
    const int c = grad ? nc - 1 - it : it, n = min(BC, S - c * BC);
    const float* const rs = ring[it % (SPD + 1)];
    const float* const ws = rs + BC * DH;
    const float* const cs = rs + 2 * BC * DH + (col - col0);
    float4 acc[NQ];
#pragma unroll
    for (int e = 0; e < NQ; ++e) acc[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    float d = 1.f;
    // G_in = A_end G_out + sum_t (r_t A_t) dy_t^T, t forward;
    // S_out = A_end S_in + sum_j (k_j B_j) v_j^T, j backward
#pragma unroll
    for (int q = 0; q < BC; ++q) {
      const int t = grad ? q : BC - 1 - q;
      if (t < n) {
        const float x = rs[t * DH + i] * d;
#pragma unroll
        for (int e = 0; e < NQ; ++e) acc[e] = axpy4(x, ld4(cs + t * SNJ + 4 * e), acc[e]);
        d *= ws[t * DH + i];
      }
    }
#pragma unroll
    for (int e = 0; e < NQ; ++e) {
      st[e] = axpy4(d, st[e], acc[e]);
      if (!grad) st4(slots + (size_t)(c + 1) * DH * DH + 4 * e, st[e]);   // S_in of chunk c + 1
      else if (c > 0) st4(slots + (size_t)(c - 1) * DH * DH + 4 * e, st[e]);   // G_out of c - 1
    }
  }
  if (grad) {
#pragma unroll
    for (int e = 0; e < NQ; ++e) st4(ds0 + sidx + 4 * e, st[e]);
  }
}

// ---------------------------------------------------------------------------
// Chunk pass: every chunk's gradients at once
// ---------------------------------------------------------------------------

// the chunk pass's shared memory, in floats, at head size DH
template <int DH>
struct ChunkLayout {
  static constexpr int RP = DH + 4;      // padded row: float4 reads of 8 rows hit 32 banks
  static constexpr int CP = BC + 1;      // padded row of SdY, GV, P's partials
  static constexpr int TQ = BNT / DH;    // thread groups over steps
  static constexpr int IW = DH / 32;     // warps sharing a step in phase 2
  static constexpr int OFF_R = 0;                        // [BC][RP], then k, w, v, dy
  static constexpr int OFF_S = 5 * BC * RP;              // S_in [DH][RP]
  static constexpr int OFF_G = OFF_S + DH * RP;          // G_out [DH][RP]
  static constexpr int OFF_SDY = OFF_G + DH * RP;        // [DH][CP]
  static constexpr int OFF_GV = OFF_SDY + DH * CP;       // [DH][CP]
  static constexpr int OFF_VDY = OFF_GV + DH * CP;       // [BC][BC]: v_j . dy_t at [j][t]
  static constexpr int OFF_KB = OFF_VDY + BC * BC;       // [BC][DH]: k_t B_t
  static constexpr int OFF_PP = OFF_KB + BC * DH;        // [IW][BC][CP]: P[m][t] at [t][m]
  static constexpr int OFF_GS = OFF_PP + IW * BC * CP;   // [DH]: <G_out[i], S_in[i]>
  static constexpr int OFF_BON = OFF_GS + DH;            // [BC]: r_t . (u k_t)
  static constexpr int OFF_DU = OFF_BON + BC;            // [TQ][DH]
  static constexpr int FLOATS = OFF_DU + TQ * DH;
  static constexpr size_t BYTES = (size_t)FLOATS * 4;
  static_assert(BNT % DH == 0 && BC % (2 * TQ) == 0 && DH % 32 == 0, "threads over (row, step)");
  static_assert(BC * BC % BNT == 0 && BC * DH / 4 <= BNT && BC == 16, "phase shapes");
  static_assert(OFF_S % 4 == 0 && OFF_G % 4 == 0 && OFF_VDY % 4 == 0 && OFF_KB % 4 == 0,
                "float4 rows");
  static_assert(BYTES <= 232448, "shared memory a block may have");
};

// head size DH; grid (nc, H, B), block BNT, ChunkLayout<DH>::BYTES dynamic
// shared memory.  du_part (B, nc, H, DH).
template <int DH>
__global__ void __launch_bounds__(BNT, DH == 32 ? 2 : 3)
wkv6_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ s0,
                      const float* __restrict__ dy, const float* __restrict__ ds_last,
                      const float* __restrict__ states, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
                      float* __restrict__ du_part, int S, int H) {
  using L = ChunkLayout<DH>;
  constexpr int RP = L::RP, CP = L::CP, TQ = L::TQ;
  extern __shared__ __align__(16) float smem[];
  float* const R = smem + L::OFF_R;
  float* const K = R + BC * RP;
  float* const W = K + BC * RP;
  float* const V = W + BC * RP;
  float* const DY = V + BC * RP;
  float* const SI = smem + L::OFF_S;
  float* const GO = smem + L::OFF_G;
  float* const SDY = smem + L::OFF_SDY;
  float* const GV = smem + L::OFF_GV;
  float* const VDY = smem + L::OFF_VDY;
  float* const KB = smem + L::OFF_KB;
  float* const PP = smem + L::OFF_PP;
  float* const GS = smem + L::OFF_GS;
  float* const BON = smem + L::OFF_BON;
  float* const DU = smem + L::OFF_DU;

  const int c = blockIdx.x, nc = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = c * BC, n = min(BC, S - t0);
  const size_t step = (size_t)H * DH;                   // between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;     // (b, 0, h, 0)
  const size_t sb = ((size_t)b * H + h) * DH * DH;      // (b, h, 0, 0)
  const size_t slot = ((size_t)b * H + h) * nc * DH * DH + (size_t)c * DH * DH;
  const float* const s_in = c == 0 ? s0 + sb : states + slot;
  const float* const g_out = c < nc - 1 ? states + (size_t)gridDim.z * H * nc * DH * DH + slot
                             : ds_last != nullptr ? ds_last + sb : nullptr;

  // phase 0: the chunk's rows (zero past n), S_in and G_out (zero without
  // ds_last) into shared memory
  for (int q = tid; q < BC * DH / 4; q += BNT) {
    const int t = q / (DH / 4), x = 4 * (q % (DH / 4));
    const bool ok = t < n;
    const size_t off = base + (size_t)(t0 + (ok ? t : 0)) * step + x;
    cp_async16(R + t * RP + x, r + off, ok);
    cp_async16(K + t * RP + x, k + off, ok);
    cp_async16(W + t * RP + x, w + off, ok);
    cp_async16(V + t * RP + x, v + off, ok);
    cp_async16(DY + t * RP + x, dy + off, ok);
  }
  for (int q = tid; q < DH * DH / 4; q += BNT) {
    const int i = q / (DH / 4), x = 4 * (q % (DH / 4));
    cp_async16(SI + i * RP + x, s_in + i * DH + x, true);
    cp_async16(GO + i * RP + x, g_out != nullptr ? g_out + i * DH + x : s_in, g_out != nullptr);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // thread (i, tq) owns BC / TQ steps of row i in phases 1a and 2, paired
  // so that every thread's walks over j < t and m > t are as long: tq, 2 TQ
  // - 1 - tq, then the same 2 TQ steps on.  A warp holds 32 rows of one step.
  const int i = tid % DH, tq = tid / DH;
  auto step_of = [&](int q) {
    return (q / 2) * 2 * TQ + (q % 2 == 0 ? tq : 2 * TQ - 1 - tq);
  };

  // phase 1a: SdY and GV of the thread's steps, <G_out[i], S_in[i]>
  {
    float a[BC / TQ], g[BC / TQ], gs = 0.f;
#pragma unroll
    for (int q = 0; q < BC / TQ; ++q) a[q] = g[q] = 0.f;
#pragma unroll 4
    for (int x = 0; x < DH; x += 4) {
      const float4 s4 = ld4(SI + i * RP + x), g4 = ld4(GO + i * RP + x);
      gs = dot4(s4, g4, gs);
#pragma unroll
      for (int q = 0; q < BC / TQ; ++q) {
        const int t = step_of(q);
        a[q] = dot4(s4, ld4(DY + t * RP + x), a[q]);
        g[q] = dot4(g4, ld4(V + t * RP + x), g[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < BC / TQ; ++q) {
      SDY[i * CP + step_of(q)] = a[q];
      GV[i * CP + step_of(q)] = g[q];
    }
    if (tq == 0) GS[i] = gs;
  }
  // phase 1b: VdY[j][t] = v_j . dy_t
  for (int q = tid; q < BC * BC; q += BNT) {
    const int j = q / BC, t = q % BC;
    float acc = 0.f;
#pragma unroll 4
    for (int x = 0; x < DH; x += 4) acc = dot4(ld4(V + j * RP + x), ld4(DY + t * RP + x), acc);
    VDY[j * BC + t] = acc;
  }
  // phase 1c: the bonus r_t . (u k_t), a warp a step
  for (int t = warp; t < BC; t += BNT / 32) {
    float p = 0.f;
#pragma unroll
    for (int x = lane; x < DH; x += 32)
      p = fmaf(R[t * RP + x] * u[(size_t)h * DH + x], K[t * RP + x], p);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
    if (lane == 0) BON[t] = p;
  }
  __syncthreads();

  // phase 2: a thread per (row i, step t); whole warps share t, so the
  // branches and the walk over j are uniform in a warp
  {
    const float uu = u[(size_t)h * DH + i];
    float du_acc = 0.f;
#pragma unroll 1
    for (int q = 0; q < BC / TQ; ++q) {
      const int t = step_of(q);
      if (t >= n) continue;
      const float ri = R[t * RP + i], ki = K[t * RP + i], beta = VDY[t * BC + t];
      // m up: rf[m] = F[t,m] r_m[i]; F ends as B_t
      float rf[BC];
      float f = 1.f, dkb = 0.f, dw2 = 0.f;
#pragma unroll
      for (int m = 0; m < BC; ++m) {
        if (m > t && m < n) {
          rf[m] = f * R[m * RP + i];
          dkb = fmaf(rf[m], VDY[t * BC + m], dkb);
          dw2 = fmaf(rf[m], SDY[i * CP + m], dw2);
          f *= W[m * RP + i];
        } else {
          rf[m] = 0.f;
        }
      }
      const float bt = f;
      // j down: D[t,j] k_j[i]; D ends as A_t
      float dd = 1.f, dra = 0.f, dw3 = 0.f, dw4 = 0.f;
      for (int j = t - 1; j >= 0; --j) {
        const float kd = dd * K[j * RP + i];
        dra = fmaf(kd, VDY[j * BC + t], dra);
        dw3 = fmaf(kd, GV[i * CP + j], dw3);
        float xs = 0.f;                          // X[t,j]
#pragma unroll
        for (int m = 0; m < BC; m += 4) {
          const float4 c4 = ld4(VDY + j * BC + m);
          xs = fmaf(rf[m + 3], c4.w, fmaf(rf[m + 2], c4.z, fmaf(rf[m + 1], c4.y,
                                                                fmaf(rf[m], c4.x, xs))));
        }
        dw4 = fmaf(kd, xs, dw4);
        dd *= W[j * RP + i];
      }
      const float at = dd;
      const size_t o = base + (size_t)(t0 + t) * step + i;
      dr[o] = fmaf(at, SDY[i * CP + t], dra) + uu * ki * beta;
      dk[o] = fmaf(bt, GV[i * CP + t], dkb) + uu * ri * beta;
      dw[o] = fmaf(at * bt, GS[i], fmaf(at, dw2, fmaf(bt, dw3, dw4)));
      KB[t * DH + i] = ki * bt;
      du_acc = fmaf(ri * ki, beta, du_acc);
      // P[m][t] over the warp's 32 rows: lane li (< 16) ends with m = li
#pragma unroll
      for (int m = 0; m < BC; ++m) {
        rf[m] *= ki;
        rf[m] += __shfl_xor_sync(0xffffffffu, rf[m], 16);
      }
      reduce_scatter<BC, 16>(rf, lane & 15);
      if (lane < 16) PP[((i / 32) * BC + t) * CP + lane] = rf[0];
    }
    DU[tq * DH + i] = du_acc;
  }
  __syncthreads();

  // phase 3: dv = G_out^T (k B) + sum_{m>t} P[m,t] dy_m + bonus dy_t, a
  // thread 4 columns of one step; du's part of the chunk
  for (int q = tid; q < BC * DH / 4; q += BNT) {
    const int t = q / (DH / 4), x = 4 * (q % (DH / 4));
    if (t < n) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int ii = 0; ii < DH; ++ii) acc = axpy4(KB[t * DH + ii], ld4(GO + ii * RP + x), acc);
      for (int m = t + 1; m < n; ++m) {
        float p = 0.f;
#pragma unroll
        for (int iw = 0; iw < L::IW; ++iw) p += PP[(iw * BC + t) * CP + m];
        acc = axpy4(p, ld4(DY + m * RP + x), acc);
      }
      acc = axpy4(BON[t], ld4(DY + t * RP + x), acc);
      st4(dv + base + (size_t)(t0 + t) * step + x, acc);
    }
  }
  if (tid < DH) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < TQ; ++g) acc += DU[g * DH + tid];
    du_part[(((size_t)b * nc + c) * H + h) * DH + tid] = acc;
  }
}

// du (H, dh): the chunks' parts summed over batch, then chunks, in order; a
// thread an element
__global__ void __launch_bounds__(256)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int B, int nc,
                   int HD) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= HD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) acc += du_part[((size_t)b * nc + c) * HD + e];
  du[e] = acc;
}

template <int DH>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, const void* dy, const void* ds_last, void* dr, void* dk,
               void* dv, void* dw, void* du, void* ds0, void* states, void* du_part, int B,
               int S, int H, cudaStream_t st) {
  using L = ChunkLayout<DH>;
  const int nc = (S + BC - 1) / BC;
  wkv6_bwd_state_kernel<DH><<<dim3(2 * DH / SNJ, H, B), DH * SNJ / SCT, 0, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)s0,
      (const float*)dy, (const float*)ds_last, (float*)ds0, (float*)states, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = wkv6_bwd_chunk_kernel<DH>;
  static bool granted = false;   // one attribute call per instantiation
  if (!granted) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::BYTES);
    if (e != cudaSuccess) return (int)e;
    granted = true;
  }
  kernel<<<dim3(nc, H, B), BNT, L::BYTES, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (const float*)s0, (const float*)dy, (const float*)ds_last, (const float*)states,
      (float*)dr, (float*)dk, (float*)dv, (float*)dw, (float*)du_part, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_du_kernel<<<ceil_div((long)H * DH, 256), 256, 0, st>>>(
      (const float*)du_part, (float*)du, B, nc, H * DH);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy (B, S, H, dh) f32, u (H, dh), s0 and ds_last (B, H, dh, dh)
//   f32 (ds_last may be null: zero) -> dr, dk, dv, dw (B, S, H, dh), du
//   (H, dh), ds0 (B, H, dh, dh), all f32; dh 32 or 64.  Scratch the caller
//   allocates, f32, nc = ceil(S / 16): states (2, B, H, nc, dh, dh), du_part
//   (B, nc, H, dh).  Three launches on `stream`.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, const void* dy,
                            const void* ds_last, void* dr, void* dk, void* dv, void* dw,
                            void* du, void* ds0, void* states, void* du_part, int B, int S,
                            int H, int dh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch_bwd<64>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, states,
                          du_part, B, S, H, st);
  if (dh == 32)
    return launch_bwd<32>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, states,
                          du_part, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}
