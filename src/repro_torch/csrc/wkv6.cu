// RWKV-6 wkv recurrence, per (batch, head) with a (Dh x Dh) f32 state S:
//
//     y_t = S_{t-1}^T r_t + (r_t . (u * k_t)) v_t
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces: src/repro/kernels/rwkv6_scan/kernel.py `wkv6` (body `_kernel`),
// the Pallas TPU kernel whose grid walks time blocks in order with S in VMEM
// scratch.  Same interface: (r, k, v, w, u, s0) -> (y, s_last), all f32.
//
// What bounds it on the H100: every input is read once and y written once,
// five operations per state element per step (y: a product and a sum; S: two
// products and a sum) against 4 x 64 x 4 bytes read per step and head, so
// device-memory bandwidth bounds it: (1, 256, 64, 64) moves 23.1 MB, 6.9 us
// at 3.35 TB/s.  The recurrence is sequential in time.
// Design: column j of S evolves on its own (S[:, j] needs only v_t[j]), so a
// block owns COLS columns of one (batch, head) and the grid is
// (Dh / COLS, H, B): 128 blocks at H = 64.  G threads share a column, thread
// g holding rows g, g + G, ... of it in registers; the G partial sums of y
// and of the bonus scalar meet by butterfly shuffles inside a warp, so a
// step needs no __syncthreads.  T steps of r, k, w (whole rows) and v (the
// block's columns) are staged in shared memory per tile, and the next tile's
// loads are issued into registers before the current tile's steps run.
// A ragged last tile runs only its valid steps.
//
// Invariance: every step does the same arithmetic whatever S is and wherever
// a call starts, so one call over 512 steps equals two chained calls over
// 256, bit for bit.  The state update is IEEE and unfused (__fmul_rn,
// __fmul_rn, __fadd_rn), the order the plain PyTorch version's elementwise
// `s * w + k * v` takes, so S agrees with it bit for bit; y sums its 64
// terms in another order than the plain version's dot product (each term a
// fused multiply-add, then the shuffle tree), so y agrees to rounding.
#include "common.cuh"

namespace {

constexpr int DH = 64;           // head size the kernel is built for
constexpr int COLS = 32;         // state columns per block
constexpr int G = 8;             // threads per column
constexpr int ROWS = DH / G;     // state rows a thread holds
constexpr int NT = COLS * G;     // threads per block
constexpr int T = 32;            // time steps per staged tile
// float4 loads per thread to stage one tile of a whole-row input (r, k, w)
// and of v's COLS columns, and to write one tile of y
constexpr int ROW_F4 = T * DH / 4 / NT;
constexpr int COL_F4 = T * COLS / 4 / NT;
static_assert(ROW_F4 * NT * 4 == T * DH && COL_F4 == 1, "tile split");

__device__ __forceinline__ float4 load_or_zero(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// grid (DH / COLS, H, B), block NT threads
__global__ void __launch_bounds__(NT)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_last, int S, int H) {
  __shared__ __align__(16) float rs[T][DH], ks[T][DH], ws[T][DH];
  __shared__ __align__(16) float vs[T][COLS], ys[T][COLS];

  const int col0 = blockIdx.x * COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid % G;          // position within the column's group
  const int c = tid / G;          // the block's column
  const int j = col0 + c;         // the state column
  const size_t step = (size_t)H * DH;                   // between time steps
  const size_t base = ((size_t)b * S * H + h) * DH;     // (b, 0, h, 0)
  const size_t sbase = ((size_t)b * H + h) * DH * DH;   // (b, h, 0, 0)

  float st[ROWS], uu[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    st[i] = s0[sbase + (size_t)(g + G * i) * DH + j];
    uu[i] = u[(size_t)h * DH + g + G * i];
  }

  // this thread's share of a tile: float4 q of a whole-row tile sits at
  // row q / (DH / 4), column 4 (q % (DH / 4)); of a column tile at row
  // tid / (COLS / 4), column 4 (tid % (COLS / 4))
  float4 pr[ROW_F4], pk[ROW_F4], pw[ROW_F4], pv;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < ROW_F4; ++n) {
      const int q = tid + n * NT;
      const int t = t0 + q / (DH / 4);
      const size_t off = base + (size_t)t * step + 4 * (q % (DH / 4));
      pr[n] = load_or_zero(r + off, t < S);
      pk[n] = load_or_zero(k + off, t < S);
      pw[n] = load_or_zero(w + off, t < S);
    }
    const int t = t0 + tid / (COLS / 4);
    pv = load_or_zero(v + base + (size_t)t * step + col0 + 4 * (tid % (COLS / 4)),
                      t < S);
  };

  const int n_tiles = (S + T - 1) / T;
  fetch(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * T;
#pragma unroll
    for (int n = 0; n < ROW_F4; ++n) {
      const int q = tid + n * NT;
      *reinterpret_cast<float4*>(&rs[q / (DH / 4)][4 * (q % (DH / 4))]) = pr[n];
      *reinterpret_cast<float4*>(&ks[q / (DH / 4)][4 * (q % (DH / 4))]) = pk[n];
      *reinterpret_cast<float4*>(&ws[q / (DH / 4)][4 * (q % (DH / 4))]) = pw[n];
    }
    *reinterpret_cast<float4*>(&vs[tid / (COLS / 4)][4 * (tid % (COLS / 4))]) = pv;
    __syncthreads();
    if (tile + 1 < n_tiles) fetch(t0 + T);   // in flight during the steps below

    const int n_steps = min(T, S - t0);
    // the state update only waits on the previous step's update, not on y:
    // it is issued before the shuffles that finish y, and steps are
    // unrolled, so one step's reduction overlaps the next step's products
#pragma unroll 4
    for (int t = 0; t < n_steps; ++t) {
      const float vj = vs[t][c];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float rk = rs[t][g + G * i];
        const float kk = ks[t][g + G * i];
        acc = fmaf(rk, st[i], acc);
        bonus = fmaf(rk, __fmul_rn(uu[i], kk), bonus);
        st[i] = __fadd_rn(__fmul_rn(st[i], ws[t][g + G * i]), __fmul_rn(kk, vj));
      }
#pragma unroll
      for (int m = 1; m < G; m <<= 1) {   // every lane of the group ends equal
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
        bonus = __fadd_rn(bonus, __shfl_xor_sync(0xffffffffu, bonus, m));
      }
      if (g == 0) ys[t][c] = fmaf(bonus, vj, acc);
    }
    __syncthreads();
    const int t = tid / (COLS / 4);
    if (t < n_steps)
      *reinterpret_cast<float4*>(y + base + (size_t)(t0 + t) * step + col0 +
                                 4 * (tid % (COLS / 4))) =
          *reinterpret_cast<const float4*>(&ys[t][4 * (tid % (COLS / 4))]);
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) s_last[sbase + (size_t)(g + G * i) * DH + j] = st[i];
}

}  // namespace

// r, k, v, w (B, S, H, 64) f32, u (H, 64) f32, s0 (B, H, 64, 64) f32
//   -> y (B, S, H, 64) f32, s_last (B, H, 64, 64) f32
extern "C" int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_last,
                        int B, int S, int H, void* stream) {
  dim3 grid(DH / COLS, H, B);
  wkv6_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_last, S, H);
  return (int)cudaGetLastError();
}
