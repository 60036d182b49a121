// RWKV-6 wkv recurrence, backward.  Per (batch, head), with the forward
//
//     y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// and G_t = dL/dS_t (G_{S-1} = ds_last, or 0 when s_last is unused), the
// walk from t = S-1 down to 0 with beta_t = v_t . dy_t:
//
//     dr_t[i] = sum_j S_{t-1}[i,j] dy_t[j] + u_i k_t[i] beta_t
//     dk_t[i] = sum_j G_t[i,j] v_t[j]     + u_i r_t[i] beta_t
//     dv_t[j] = sum_i k_t[i] G_t[i,j]     + (r_t . (u * k_t)) dy_t[j]
//     dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] beta_t           (over batch and time)
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T      -> ds0 = G_{-1}
//
// The backward of: src/repro/kernels/rwkv6_scan/kernel.py `wkv6` (the
// reference trains through jax.grad of its plain scans, so there is no TPU
// backward kernel to translate; this is the gradient of the forward that
// csrc/wkv6.cu ports).  The Python wrapper's `wkv6_backward_plain` is this
// algorithm in plain torch.
//
// Like S, G evolves column by column: column j of G needs w, r (all rows)
// and dy[j] only.  So a block of 512 threads owns 512 / Dh state columns of
// one (batch, head), one element of S and of G a thread: grid (Dh^2 / 512,
// H, B).  Built for head sizes 64 (8 columns a block) and 32 (16), as
// wkv6.cu.
//
// * Phase A walks the chunks of BC steps forward from s0 and writes S at
//   every chunk start into a scratch buffer the wrapper allocates.
// * Phase B walks the chunks in reverse.  For a chunk it rebuilds S_{t-1}
//   for each of its steps from the saved start, step by step, in registers
//   (8 floats a thread), then runs the steps above from the last step down.
//   S is never rebuilt by dividing by w, so w = 0 and strong decay need no
//   special case.
//
// Every sum is made in a fixed order and none with atomics, so two calls
// give the same bits: sums over the block's columns by shuffles; dv's sum
// over the rows by shuffles within a warp, then over the 16 warps in shared
// memory in warp order; a step's bonus and beta by one warp's shuffles; the
// sums over the column blocks (dr, dk, dw) by a second kernel that reads
// the blocks' partials in block order and adds the bonus terms; du's sum
// over time within each (batch, head) (column block 0's threads, in time
// order), then over the batch in that second kernel.
//
// Shared memory (static; 20,544 bytes a block at Dh 64, 16,448 at 32): the
// chunk's rows of r, k, w, v, dy (5 x 8 x Dh f32), dv's per-warp sums (8 x
// 16 x 512 / Dh), the chunk's partials of dr, dk, dw (3 x 8 x Dh), its bonus
// and beta.  ptxas gives a 512-thread block 64 registers a thread, so two
// blocks share an SM; with chunks of 16 steps it spilled the longer state
// history at that cap.
//
// What bounds it on the H100: it reads r, k, v, w, dy, s0, ds_last and
// writes dr, dk, dv, dw, ds0 once, against about 14 f32 operations a state
// element a step (the state rebuilt, the four products, G's update):
// (2, 64, 64, 64) moves 25.2 MB, 7.5 us at 3.35 TB/s, and does 0.47 GFLOP,
// 7.0 us at 67 TFLOP/s.  This first version also writes and reads the
// partials (24 floats per input float) and the chunk starts, and walks the
// state twice; and it spends 11 shuffles a state element a step (the sums
// over columns and rows), which by count is what holds it back.
#include "common.cuh"

namespace {

constexpr int BC = 8;             // steps a chunk
constexpr int BNT = 512;          // threads a block: one state element each
constexpr int BW = BNT / 32;      // warps a block
constexpr int RROWS = 4;          // rows of Dh a block of the second kernel
static_assert(BW >= BC, "a warp for each step's bonus and beta");

__device__ __forceinline__ float state_step(float s, float w, float k, float v) {
  // the plain version's product, product, sum (no fused multiply-add)
  return __fadd_rn(__fmul_rn(s, w), __fmul_rn(k, v));
}

// head size DH; grid (NB, H, B), block BNT.  starts (B, H, nc, DH, DH): S
// at each chunk start (chunk 0's is s0, not written); part (3, NB, B, S, H,
// DH): the column blocks' sums of dr, dk, dw; beta (B, S, H); du_part (B,
// H, DH).
template <int DH>
__global__ void __launch_bounds__(BNT)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ ds_last,
                float* __restrict__ dv, float* __restrict__ ds0,
                float* __restrict__ starts, float* __restrict__ part,
                float* __restrict__ beta, float* __restrict__ du_part, int S, int H) {
  constexpr int BNJ = BNT / DH;   // state columns a block
  constexpr int NB = DH / BNJ;    // column blocks of a (batch, head)
  __shared__ __align__(16) float sr[BC][DH], sk[BC][DH], sw[BC][DH], sv[BC][DH], sdy[BC][DH];
  __shared__ float sdv[BC][BW][BNJ];
  __shared__ float spart[3][BC][DH];
  __shared__ float sbonus[BC], sbeta[BC];

  const int nb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / BNJ, j = tid % BNJ, col = nb * BNJ + j;
  const size_t step = (size_t)H * DH;                   // between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;     // (b, 0, h, 0)
  const size_t sidx = ((size_t)b * H + h) * DH * DH + (size_t)i * DH + col;
  const size_t plane = (size_t)gridDim.z * S * H * DH;  // one (f, nb) of part
  const int nc = (S + BC - 1) / BC;
  float* const st = starts + ((size_t)b * H + h) * nc * DH * DH + (size_t)i * DH + col;

  // chunk c's rows into shared memory (r and dy only for phase B)
  auto load = [&](int c, bool all) {
    const int t0 = c * BC, n = min(BC, S - t0);
    for (int q = tid; q < n * DH; q += BNT) {
      const int t = q / DH, x = q % DH;
      const size_t off = base + (size_t)(t0 + t) * step + x;
      sk[t][x] = k[off];
      sw[t][x] = w[off];
      sv[t][x] = v[off];
      if (all) {
        sr[t][x] = r[off];
        sdy[t][x] = dy[off];
      }
    }
  };

  // phase A: S at the start of chunks 1 .. nc - 1 (every chunk before the
  // last is whole)
  {
    float s = s0[sidx];
    for (int c = 0; c + 1 < nc; ++c) {
      __syncthreads();
      load(c, false);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < BC; ++t) s = state_step(s, sw[t][i], sk[t][i], sv[t][col]);
      st[(size_t)(c + 1) * DH * DH] = s;
    }
  }

  // phase B: the chunks in reverse, G carried between them
  float g = ds_last != nullptr ? ds_last[sidx] : 0.f;
  float dup = 0.f;                  // sum_t r k beta of row i (column block 0)
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * BC, n = min(BC, S - t0);
    __syncthreads();                // the last chunk's shared reads are done
    load(c, true);
    __syncthreads();
    if (warp < n) {                 // bonus r . (u * k) and beta = v . dy of step `warp`
      float bo = 0.f, be = 0.f;
#pragma unroll
      for (int x = lane; x < DH; x += 32) {
        bo = fmaf(sr[warp][x] * u[(size_t)h * DH + x], sk[warp][x], bo);
        be = fmaf(sv[warp][x], sdy[warp][x], be);
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        bo += __shfl_xor_sync(0xffffffffu, bo, m);
        be += __shfl_xor_sync(0xffffffffu, be, m);
      }
      if (lane == 0) {
        sbonus[warp] = bo;
        sbeta[warp] = be;
      }
    }
    // S_{t-1} of every step of the chunk, from the chunk's start
    float hist[BC];
    hist[0] = c == 0 ? s0[sidx] : st[(size_t)c * DH * DH];
#pragma unroll
    for (int t = 1; t < BC; ++t)
      hist[t] = t < n ? state_step(hist[t - 1], sw[t - 1][i], sk[t - 1][i], sv[t - 1][col]) : 0.f;
    __syncthreads();                // sbonus, sbeta
#pragma unroll
    for (int t = BC - 1; t >= 0; --t) {
      if (t < n) {                  // n is the block's: whole warps take the branch
        const float sp = hist[t], rr = sr[t][i], dyj = sdy[t][col], vj = sv[t][col];
        float a = sp * dyj, bk = g * vj, cw = g * sp, d = sk[t][i] * g;
#pragma unroll
        for (int m = 1; m < BNJ; m <<= 1) {   // over the block's columns of row i
          a += __shfl_xor_sync(0xffffffffu, a, m);
          bk += __shfl_xor_sync(0xffffffffu, bk, m);
          cw += __shfl_xor_sync(0xffffffffu, cw, m);
        }
#pragma unroll
        for (int m = BNJ; m < 32; m <<= 1)    // over the warp's rows of column j
          d += __shfl_xor_sync(0xffffffffu, d, m);
        if (j == 0) {
          spart[0][t][i] = a;
          spart[1][t][i] = bk;
          spart[2][t][i] = cw;
        }
        if (lane < BNJ) sdv[t][warp][lane] = d;
        if (nb == 0 && j == 0) dup = fmaf(rr * sk[t][i], sbeta[t], dup);
        g = state_step(g, sw[t][i], rr, dyj);
      }
    }
    __syncthreads();
    // the chunk's dv of the block's columns, its partials, its beta
    for (int q = tid; q < n * BNJ; q += BNT) {
      const int t = q / BNJ, jj = q % BNJ;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < BW; ++wp) acc += sdv[t][wp][jj];
      const int cj = nb * BNJ + jj;
      dv[base + (size_t)(t0 + t) * step + cj] = fmaf(sbonus[t], sdy[t][cj], acc);
    }
    for (int q = tid; q < 3 * n * DH; q += BNT) {
      const int f = q / (n * DH), t = (q / DH) % n, x = q % DH;
      part[(size_t)(f * NB + nb) * plane + base + (size_t)(t0 + t) * step + x] = spart[f][t][x];
    }
    if (nb == 0 && tid < n) beta[((size_t)b * S + t0 + tid) * H + h] = sbeta[tid];
  }
  ds0[sidx] = g;
  if (nb == 0 && j == 0) du_part[((size_t)b * H + h) * DH + i] = dup;
}

// Blocks 0 .. ceil(R / RROWS) - 1: RROWS of the R = B * S * H rows of DH a
// block, the column blocks' partials summed in block order plus the bonus
// terms.  The next ceil(H / RROWS) blocks: du, the batch's sums in batch
// order.
template <int DH>
__global__ void __launch_bounds__(RROWS * DH)
wkv6_bwd_reduce_kernel(const float* __restrict__ part, const float* __restrict__ r,
                       const float* __restrict__ k, const float* __restrict__ u,
                       const float* __restrict__ beta, const float* __restrict__ du_part,
                       float* __restrict__ dr, float* __restrict__ dk,
                       float* __restrict__ dw, float* __restrict__ du, int B, int R,
                       int H) {
  constexpr int NB = DH * DH / BNT;
  const int x = threadIdx.x % DH, q = threadIdx.x / DH;
  const int row_blocks = (R + RROWS - 1) / RROWS;
  if ((int)blockIdx.x >= row_blocks) {
    const int h = ((int)blockIdx.x - row_blocks) * RROWS + q;
    if (h >= H) return;
    float acc = 0.f;
    for (int bb = 0; bb < B; ++bb) acc += du_part[((size_t)bb * H + h) * DH + x];
    du[(size_t)h * DH + x] = acc;
    return;
  }
  const int row = blockIdx.x * RROWS + q;
  if (row >= R) return;
  const size_t idx = (size_t)row * DH + x, plane = (size_t)R * DH;
  float a = 0.f, bk = 0.f, cw = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    a += part[(size_t)nb * plane + idx];
    bk += part[(size_t)(NB + nb) * plane + idx];
    cw += part[(size_t)(2 * NB + nb) * plane + idx];
  }
  const float be = beta[row], uu = u[(size_t)(row % H) * DH + x];
  dr[idx] = fmaf(uu * k[idx], be, a);
  dk[idx] = fmaf(uu * r[idx], be, bk);
  dw[idx] = cw;
}

template <int DH>
int launch_bwd(const void* r, const void* k, const void* v, const void* w, const void* u,
               const void* s0, const void* dy, const void* ds_last, void* dr, void* dk,
               void* dv, void* dw, void* du, void* ds0, void* starts, void* part,
               void* beta, void* du_part, int B, int S, int H, cudaStream_t st) {
  constexpr int NB = DH * DH / BNT;
  wkv6_bwd_kernel<DH><<<dim3(NB, H, B), BNT, 0, st>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, (const float*)u,
      (const float*)s0, (const float*)dy, (const float*)ds_last, (float*)dv, (float*)ds0,
      (float*)starts, (float*)part, (float*)beta, (float*)du_part, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = B * S * H;
  const int blocks = (rows + RROWS - 1) / RROWS + (H + RROWS - 1) / RROWS;
  wkv6_bwd_reduce_kernel<DH><<<blocks, RROWS * DH, 0, st>>>(
      (const float*)part, (const float*)r, (const float*)k, (const float*)u,
      (const float*)beta, (const float*)du_part, (float*)dr, (float*)dk, (float*)dw,
      (float*)du, B, rows, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy (B, S, H, dh) f32, u (H, dh), s0 and ds_last (B, H, dh, dh)
//   f32 (ds_last may be null: zero) -> dr, dk, dv, dw (B, S, H, dh), du
//   (H, dh), ds0 (B, H, dh, dh), all f32; dh 32 or 64.  Scratch the caller
//   allocates, f32: starts (B, H, ceil(S / 16), dh, dh), part (3, dh^2 / 512,
//   B, S, H, dh), beta (B, S, H), du_part (B, H, dh).  Two launches on
//   `stream`.
extern "C" int wkv6_bwd_f32(const void* r, const void* k, const void* v, const void* w,
                            const void* u, const void* s0, const void* dy,
                            const void* ds_last, void* dr, void* dk, void* dv, void* dw,
                            void* du, void* ds0, void* starts, void* part, void* beta,
                            void* du_part, int B, int S, int H, int dh, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (dh == 64)
    return launch_bwd<64>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, starts,
                          part, beta, du_part, B, S, H, st);
  if (dh == 32)
    return launch_bwd<32>(r, k, v, w, u, s0, dy, ds_last, dr, dk, dv, dw, du, ds0, starts,
                          part, beta, du_part, B, S, H, st);
  return (int)cudaErrorInvalidValue;
}
