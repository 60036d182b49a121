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
// else -1.  Online softmax in f32, in the log2 domain; probabilities are
// rounded to bf16 before the P.V product, as the plain version does.  A
// query row with no visible slot gets what the plain version's finite
// -1e30 mask gives it: a uniform softmax over all S slots, bf16(1/S) times
// the sum of V over [0, S).
//
// What bounds it on the H100: the operations.  qwen3-8b's timed shape (a
// 256-token chunk at q_offset 3840 over 4096 keys, Hq 32, Hkv 8, Dh 128)
// is 17.2 GFLOP of visible (query, key) products over 21 MB of inputs, 17
// us at 989 TFLOP/s against 6 us for the bytes; recurrentgemma-2b's (Hq
// 10, Hkv 1, Dh 256, 256 rows over a 2048-slot ring, window 2048) 5.0
// GFLOP over 3.4 MB, 5 us against 1 us; qwen1.5-0.5b's (Hq = Hkv = 16, Dh
// 64, the same chunk as qwen3's) 4.2 GFLOP over 18 MB, 4 us against 5 us:
// there the bytes bound it.  What the design does about it:
//
// 1. Pack the G query heads of a KV head into the row dimension.  A block
//    owns an M tile of 64 (query row, head) pairs of one KV head, ordered
//    p = i * G + g, and one split of the cache; every K/V tile it stages
//    feeds all 64 pairs.  A pair knows its own row and so its own query
//    position: G = 10 packs as well as G = 4, and where 64 is no multiple
//    of G (3, 10, 12) a query row's heads straddle two M tiles, each pair
//    still a whole softmax of its own.
// 2. Both products on the tensor cores with wgmma (sm_90a): the block's
//    64 pairs are the M of m64n64k16 for S = Q K^T (Q and K from shared
//    memory) and of m64n{Dh}k16, Dh 64, 128 or 256, for O += P V (P from
//    registers, V from shared memory, transposed).  Tiles are staged in the 128-byte-swizzled
//    layout the matrix descriptors name.  Scores, the online softmax and O
//    stay in registers (the accumulator layout is mma.sync's, a warp per
//    16 pairs).
// 3. Two warpgroups a block at Dh 64 and 128.  One warpgroup alone leaves
//    the tensor cores idle while it runs its softmax; at Dh 64 and 128 each
//    block has two, which walk alternate live tiles of the block's split
//    with their own online softmax and merge (m, l, O) through shared memory
//    at the end — a split of the cache inside the block, with no partials
//    in device memory.  At Dh 64 the O accumulators take 32 registers a
//    thread (64 at Dh 128), so the registers allow it as well as at 128.
//    At Dh 256 the O accumulators take 128 registers a thread and K/V tiles
//    twice the shared memory: one warpgroup a block.
// 4. Fill the card.  The plan (repro_torch.kernels.flash_prefill._plan)
//    splits the cache across blocks only where the M tiles alone leave SMs
//    idle: qwen3's 256-row chunk is 8 x 16 = 128 blocks and no split; the
//    hybrid's 40 M tiles and the 64-row suffix chunks split the cache and a
//    second kernel combines the splits' f32 partials (m, l, acc).
// 5. Copies in flight behind the products.  Each warpgroup stages its K, V
//    and kpos tiles of 64 slots through a two-stage ring with cp.async
//    (16-byte copies); its next tile lands while the current one is used.
// 6. The exact tile skip, without copying dead tiles: before the ring
//    starts, the block reads its split's kpos once and marks each 64-slot
//    tile dead (no pair of the block sees any slot), full (every pair sees
//    every slot: no per-element mask) or partial, from kpos against the
//    block's span of query positions — right for any cache layout (rings,
//    stale slots, empty slots) — and walks the live tiles only.
// Ragged Sq and S are masked in the kernel: no padding copies.  Left for
// later: TMA, warp specialisation, persistent blocks.
#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int FP_M = 64;                    // pairs a block: M_TILE in the wrapper
constexpr int FP_BK = 64;                   // slots a key tile: TILE in the wrapper
constexpr int TILE_PARTIAL = 1 << 30;       // a live tile some pair sees only in part
constexpr int TILE_ANY = 1, TILE_NOT_ALL = 2;
constexpr size_t MAX_SMEM = 232448 - 1024;  // what a block may use on sm_90,
                                            // less the static n_live_s

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- wgmma (sm_90a): a warpgroup's asynchronous 64-row products ---------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// matrix descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) . B (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 128, f32) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64 x 256, f32) += A (64 x 16, registers) . B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ bool visible(int kp, int qpos, int window) {
  return kp >= 0 && kp <= qpos && (window <= 0 || kp > qpos - window);
}

// the weight of each slot in a row with no visible slot: 1/S rounded to
// bf16, as the plain version's uniform softmax is before P.V
__device__ __forceinline__ float uniform_weight(int S) {
  return __bfloat162float(__float2bfloat16_rn(1.f / (float)S));
}

// Shared memory of a block: the K and V rings (STAGES tiles a warpgroup),
// the Q tile, the kpos ring, then per tile of the split its flags and the
// list of live tiles.  A staged tile of 64 rows (slots or pairs) is laid
// out as the matrix descriptors name it: Dh/64 regions (one at Dh 64) of 64
// rows x 128 bytes, 16-byte chunk c of row r at ((c ^ (r % 8)) * 16) in its
// row, each region 1024-byte aligned.
template <int DH>
struct Layout {
  static constexpr int NWG = DH <= 128 ? 2 : 1;   // warpgroups a block (point 3)
  static constexpr int NT = 128 * NWG;
  static constexpr int STAGES = 2;
  static constexpr size_t tile = (size_t)FP_BK * DH * 2;
  static constexpr size_t v_off = NWG * STAGES * tile;
  static constexpr size_t q_off = 2 * NWG * STAGES * tile;
  static constexpr size_t kp_off = q_off + (size_t)FP_M * DH * 2;
  static constexpr size_t fl_off = kp_off + (size_t)NWG * STAGES * FP_BK * sizeof(int);
  static size_t bytes(int split_tiles) {
    return 1024 + fl_off + (size_t)split_tiles * 2 * sizeof(int);
  }
  static __device__ __forceinline__ int chunk(int r, int c) {
    return (c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
};

// the threads of warpgroup wg meet (the whole block when it is the only one)
template <int NWG>
__device__ __forceinline__ void wg_sync(int wg) {
  if constexpr (NWG == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// grid (M tiles, Hkv * n_split, B); block NT threads.  Block (x, y, b) owns
// pairs x*FP_M .. x*FP_M + 63 of KV head y / n_split and the slots
// [split * split_slots, min(S, (split + 1) * split_slots)) of the cache.
// n_split == 1 writes `out`; otherwise each pair's (m, l, acc) of its split
// goes to the f32 partials for flash_prefill_combine_kernel.
template <int DH>
__global__ void __launch_bounds__(Layout<DH>::NT)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ kpos,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ m_part, float* __restrict__ l_part,
                     float* __restrict__ acc_part,
                     int Sq, int S, int Hq, int Hkv, int G, int q_offset,
                     int window, float scale, int n_split, int split_slots) {
  using L = Layout<DH>;
  constexpr int NWG = L::NWG, NT = L::NT, STAGES = L::STAGES, BK = FP_BK, CH = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::v_off;
  unsigned char* Qs = smem + L::q_off;
  int* kps = reinterpret_cast<int*>(smem + L::kp_off);
  int* flags = reinterpret_cast<int*>(smem + L::fl_off);
  __shared__ int n_live_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid >> 7, wtid = tid & 127;   // warpgroup, thread within it
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / n_split, split = blockIdx.y % n_split;
  const int npairs = Sq * G, p0 = blockIdx.x * FP_M;
  const int j_lo = split * split_slots, j_hi = min(S, j_lo + split_slots);
  const int ntiles = (j_hi - j_lo + BK - 1) / BK;
  int* live = flags + ntiles;

  const size_t q_row = (size_t)Hq * DH, kv_row = (size_t)Hkv * DH;
  const __nv_bfloat16* kb = k + (size_t)b * S * kv_row + (size_t)kvh * DH;
  const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)kvh * DH;
  // pair p of this KV head lies at row p / G, head kvh * G + p % G
  auto pair_off = [&](int p) {
    return ((size_t)b * Sq + p / G) * q_row + (size_t)(kvh * G + p % G) * DH;
  };

  // 1. the block's Q rows (cp.async group 0; rows past the last pair zero)
  for (int idx = tid; idx < FP_M * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, p = p0 + r;
    cp_async16(Qs + L::chunk(r, c), q + pair_off(p < npairs ? p : p0) + c * 8,
               p < npairs);
  }
  cp_async_commit();

  // 2. classify the split's tiles from kpos against the block's span of
  // query positions: dead, full or partial; list the live ones in order
  const int q_min = q_offset + p0 / G;
  const int q_max = q_offset + (min(npairs, p0 + FP_M) - 1) / G;
  for (int t = tid; t < ntiles; t += NT) flags[t] = 0;
  __syncthreads();
  for (int j0 = j_lo; j0 < j_hi; j0 += 8 * NT) {
    int kp[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * NT + tid;
      kp[u] = j < j_hi ? __ldg(kpos + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      // a warp's 32 slots lie in one tile: one vote and one atomic a warp
      const int j = j0 + u * NT + tid;
      const int t = (j0 + u * NT + warp * 32 - j_lo) / BK;
      if (t >= ntiles) break;
      const bool any = kp[u] >= 0 && kp[u] <= q_max &&
                       (window <= 0 || kp[u] > q_min - window);
      const bool all = j < j_hi && kp[u] >= 0 && kp[u] <= q_min &&
                       (window <= 0 || kp[u] > q_max - window);
      const unsigned a = __ballot_sync(0xffffffffu, any);
      const unsigned na = __ballot_sync(0xffffffffu, !all);
      if (lane == 0 && (a | na))
        atomicOr(&flags[t], (a ? TILE_ANY : 0) | (na ? TILE_NOT_ALL : 0));
    }
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const int f = t < ntiles ? flags[t] : 0;
      // the ragged last tile of the split holds slots of no one: partial
      const bool ragged = t == ntiles - 1 && (j_hi - j_lo) % BK != 0;
      const unsigned alive = __ballot_sync(0xffffffffu, f & TILE_ANY);
      if (f & TILE_ANY)
        live[base + __popc(alive & ((1u << lane) - 1u))] =
            t | ((f & TILE_NOT_ALL) || ragged ? TILE_PARTIAL : 0);
      base += __popc(alive);
    }
    if (lane == 0) n_live_s = base;
  }
  __syncthreads();
  const int n_live = n_live_s;

  // 3. warpgroup wg walks live tiles wg, wg + NWG, ...: its i-th lands in
  // stage i % STAGES of its own ring
  const int n_mine = n_live > wg ? (n_live - wg + NWG - 1) / NWG : 0;
  auto ring = [&](int st) { return (wg * STAGES + st); };
  auto copy_tile = [&](int i, int st) {
    const int j0 = j_lo + (live[wg + i * NWG] & (TILE_PARTIAL - 1)) * BK;
    unsigned char* kd = Ks + ring(st) * L::tile;
    unsigned char* vd = Vs + ring(st) * L::tile;
#pragma unroll
    for (int n = 0; n < BK * CH / 128; ++n) {
      const int idx = wtid + n * 128;
      const int r = idx / CH, c = idx % CH, j = j0 + r;
      const size_t off = (size_t)(j < j_hi ? j : j_lo) * kv_row + c * 8;
      cp_async16(kd + L::chunk(r, c), kb + off, j < j_hi);
      cp_async16(vd + L::chunk(r, c), vb + off, j < j_hi);
    }
    if (wtid < BK)
      cp_async4(kps + ring(st) * BK + wtid, kpos + (j0 + wtid < j_hi ? j0 + wtid : j_lo),
                j0 + wtid < j_hi);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_mine) copy_tile(st, st);
    cp_async_commit();   // empty groups keep the wait count uniform
  }
  // every thread's Q copies, seen by every warpgroup's wgmma
  cp_async_wait<STAGES - 1>();
  fence_proxy_async();
  __syncthreads();

  // this thread's two pairs (rows g and g + 8 of its warp's 16)
  const int pr_lo = p0 + (warp & 3) * 16 + (lane >> 2), pr_hi = pr_lo + 8;
  const int qp_lo = q_offset + pr_lo / G, qp_hi = q_offset + pr_hi / G;
  const int quad = lane & 3;
  const float sl2 = scale * LOG2E;

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float s[BK / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, log2 domain
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums

  for (int i = 0; i < n_mine; ++i) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile i
    fence_proxy_async();
    wg_sync<NWG>(wg);              // the warpgroup's; stage (i-1) % STAGES is free
    if (i + STAGES - 1 < n_mine) copy_tile(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = i % STAGES, ent = live[wg + i * NWG];
    const int j0 = j_lo + (ent & (TILE_PARTIAL - 1)) * BK;
    const unsigned char* Kt = Ks + ring(st) * L::tile;
    const unsigned char* Vt = Vs + ring(st) * L::tile;

    // S = Q K^T for the 64 pairs x BK slots (a warp's 16 pairs in s); a
    // K-major 16-column step is 32 bytes into its 128-byte rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss_n64(&s[0][0], sw128_desc(Qs + off, 16, 1024),
                   sw128_desc(Kt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    // mask (partial tiles only), row max over the tile
    if (ent & TILE_PARTIAL) {
      const int* kt = kps + ring(st) * BK;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + quad * 2 + (e & 1);
          if (!(j0 + col < j_hi && visible(kt[col], e >= 2 ? qp_hi : qp_lo, window)))
            s[nt][e] = -INFINITY;
        }
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * sl2), mn_hi = fmaxf(m_hi, mx_hi * sl2);
    // a row with nothing visible yet subtracts 0, not -inf: its masked
    // scores give exp2(-inf) = 0 and no -inf - -inf is formed
    const float b_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float b_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float c_lo = exp2f(m_lo - b_lo), c_hi = exp2f(m_hi - b_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], sl2, -b_lo));
      s[nt][1] = exp2f(fmaf(s[nt][1], sl2, -b_lo));
      s[nt][2] = exp2f(fmaf(s[nt][2], sl2, -b_hi));
      s[nt][3] = exp2f(fmaf(s[nt][3], sl2, -b_hi));
      l_lo += s[nt][0] + s[nt][1];
      l_hi += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      o[nd][0] *= c_lo; o[nd][1] *= c_lo;
      o[nd][2] *= c_hi; o[nd][3] *= c_hi;
    }

    // O += P V : P (the warp's 16 pairs x BK, bf16) from the S accumulators
    // in registers until the wait; V (BK x DH) MN-major: 8-slot groups 1024
    // bytes apart, 64-column regions 64 * 128 bytes apart
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int k2 = 0; k2 < BK / 16; ++k2) {
      pa[k2][0] = pack_bf16(s[2 * k2][0], s[2 * k2][1]);
      pa[k2][1] = pack_bf16(s[2 * k2][2], s[2 * k2][3]);
      pa[k2][2] = pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
      pa[k2][3] = pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < BK / 16; ++k2) {
      const uint64_t dv = sw128_desc(Vt + k2 * 2048, 64 * 128, 1024);
      if constexpr (DH == 64) wgmma_rs_n64(&o[0][0], pa[k2], dv);
      else if constexpr (DH == 128) wgmma_rs_n128(&o[0][0], pa[k2], dv);
      else wgmma_rs_n256(&o[0][0], pa[k2], dv);
    }
    wgmma_commit();
    wgmma_wait0();
  }
  cp_async_wait<0>();  // no copy may outlive the block

  // each row's sum is spread over the 4 lanes of its quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }

  // 4. warpgroups past the first hand their (m, l, O) to warpgroup 0 through
  // shared memory (the rings are free), element-major so that a warp's
  // stores fall in distinct banks; a state with m = -inf weighs 0
  if constexpr (NWG > 1) {
    constexpr int E = 4 + DH / 2;                 // floats a thread hands over
    float* x = reinterpret_cast<float*>(smem);    // [NWG - 1][E][128]
    __syncthreads();
    if (wg > 0) {
      float* y = x + (size_t)(wg - 1) * E * 128 + wtid;
      y[0] = m_lo; y[128] = m_hi; y[256] = l_lo; y[384] = l_hi;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[(4 + nd * 4 + e) * 128] = o[nd][e];
    }
    __syncthreads();
    if (wg == 0) {
#pragma unroll 1
      for (int w = 1; w < NWG; ++w) {
        const float* y = x + (size_t)(w - 1) * E * 128 + wtid;
        const float m2_lo = y[0], m2_hi = y[128];
        const float M_lo = fmaxf(m_lo, m2_lo), M_hi = fmaxf(m_hi, m2_hi);
        const float a_lo = m_lo == -INFINITY ? 0.f : exp2f(m_lo - M_lo);
        const float a_hi = m_hi == -INFINITY ? 0.f : exp2f(m_hi - M_hi);
        const float z_lo = m2_lo == -INFINITY ? 0.f : exp2f(m2_lo - M_lo);
        const float z_hi = m2_hi == -INFINITY ? 0.f : exp2f(m2_hi - M_hi);
        l_lo = l_lo * a_lo + y[256] * z_lo;
        l_hi = l_hi * a_hi + y[384] * z_hi;
#pragma unroll
        for (int nd = 0; nd < DH / 8; ++nd) {
          o[nd][0] = o[nd][0] * a_lo + y[(4 + nd * 4) * 128] * z_lo;
          o[nd][1] = o[nd][1] * a_lo + y[(5 + nd * 4) * 128] * z_lo;
          o[nd][2] = o[nd][2] * a_hi + y[(6 + nd * 4) * 128] * z_hi;
          o[nd][3] = o[nd][3] * a_hi + y[(7 + nd * 4) * 128] * z_hi;
        }
        m_lo = M_lo;
        m_hi = M_hi;
      }
    }
  }
  // warpgroup 0 holds the block's answer
  const bool in_lo = wg == 0 && pr_lo < npairs, in_hi = wg == 0 && pr_hi < npairs;

  if (n_split > 1) {
    // this split's partials (m = -inf, l = 0, acc = 0 when it saw nothing)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = h ? pr_hi : pr_lo;
      if (!(h ? in_hi : in_lo)) continue;
      const size_t row = (((size_t)b * Sq + p / G) * Hq + kvh * G + p % G) * n_split + split;
      float* acc = acc_part + row * DH + quad * 2;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd)
        *reinterpret_cast<float2*>(acc + nd * 8) =
            make_float2(o[nd][2 * h], o[nd][2 * h + 1]);
      if (quad == 0) {
        m_part[row] = h ? m_hi : m_lo;
        l_part[row] = h ? l_hi : l_lo;
      }
    }
    return;
  }

  // rows with no visible slot: the mean of V over all S slots of the KV
  // head, summed once by the whole block (the rings are free)
  const bool dead_lo = in_lo && m_lo == -INFINITY, dead_hi = in_hi && m_hi == -INFINITY;
  float* vsum = reinterpret_cast<float*>(smem);                 // [DH]
  if (__syncthreads_or(dead_lo || dead_hi)) {
    constexpr int NG = NT / CH;                                 // row groups
    float* red = vsum + DH;                                     // [NG][DH]
    const int c = tid % CH, grp = tid / CH;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = grp; j < S; j += NG) {
      const uint4 w = *reinterpret_cast<const uint4*>(vb + (size_t)j * kv_row + c * 8);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * e] += __uint_as_float(u[e] << 16);
        acc[2 * e + 1] += __uint_as_float(u[e] & 0xffff0000u);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[grp * DH + c * 8 + e] = acc[e];
    __syncthreads();
    for (int d = tid; d < DH; d += NT) {
      float t = 0.f;
      for (int g2 = 0; g2 < NG; ++g2) t += red[g2 * DH + d];
      vsum[d] = t * uniform_weight(S);
    }
    __syncthreads();
  }

  const float il_lo = 1.f / fmaxf(l_lo, 1e-30f), il_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    const int d = nd * 8 + quad * 2;
    if (in_lo)
      *reinterpret_cast<uint32_t*>(out + pair_off(pr_lo) + d) =
          dead_lo ? pack_bf16(vsum[d], vsum[d + 1])
                  : pack_bf16(o[nd][0] * il_lo, o[nd][1] * il_lo);
    if (in_hi)
      *reinterpret_cast<uint32_t*>(out + pair_off(pr_hi) + d) =
          dead_hi ? pack_bf16(vsum[d], vsum[d + 1])
                  : pack_bf16(o[nd][2] * il_hi, o[nd][3] * il_hi);
  }
}

// a warp per (batch row, query row, query head): M = max_s m_s, out =
// sum_s 2^{m_s-M} acc_s / sum_s 2^{m_s-M} l_s, rounded to bf16 once.  A
// split with m = -inf weighs 0 (never exp2(-inf - M)); a row where every
// split has m = -inf takes the mean of V over all S slots.
constexpr int FC_WARPS = 8;

template <int DH>
__global__ void __launch_bounds__(32 * FC_WARPS)
flash_prefill_combine_kernel(const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             const float* __restrict__ acc_part,
                             const __nv_bfloat16* __restrict__ v,
                             __nv_bfloat16* __restrict__ out, int rows, int Sq,
                             int S, int Hq, int Hkv, int G, int n_split) {
  constexpr int DPL = DH / 32;   // columns a lane owns: 2, 4 or 8
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * FC_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t r0 = (size_t)row * n_split;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, m_part[r0 + s]);
  float num[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) num[e] = 0.f;
  float scale;
  if (M == -INFINITY) {
    const int h = row % Hq, b = row / (Hq * Sq);
    const size_t kv_row = (size_t)Hkv * DH;
    const __nv_bfloat16* vb = v + (size_t)b * S * kv_row + (size_t)(h / G) * DH + lane * DPL;
#pragma unroll 4
    for (int j = 0; j < S; ++j) {
      const __nv_bfloat16* src = vb + (size_t)j * kv_row;
#pragma unroll
      for (int e = 0; e < DPL; ++e) num[e] += __bfloat162float(src[e]);
    }
    scale = uniform_weight(S);
  } else {
    float den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float ms = m_part[r0 + s];
      const float w = ms == -INFINITY ? 0.f : exp2f(ms - M);
      den = fmaf(w, l_part[r0 + s], den);
      const float* a = acc_part + (r0 + s) * DH + lane * DPL;
      if constexpr (DPL % 4 == 0) {
#pragma unroll
        for (int e = 0; e < DPL / 4; ++e) {
          const float4 x = reinterpret_cast<const float4*>(a)[e];
          num[4 * e] = fmaf(w, x.x, num[4 * e]);
          num[4 * e + 1] = fmaf(w, x.y, num[4 * e + 1]);
          num[4 * e + 2] = fmaf(w, x.z, num[4 * e + 2]);
          num[4 * e + 3] = fmaf(w, x.w, num[4 * e + 3]);
        }
      } else {   // Dh 64: a lane's two columns in one 8-byte load
        const float2 x = *reinterpret_cast<const float2*>(a);
        num[0] = fmaf(w, x.x, num[0]);
        num[1] = fmaf(w, x.y, num[1]);
      }
    }
    scale = 1.f / fmaxf(den, 1e-30f);
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * DH + lane * DPL);
#pragma unroll
  for (int e = 0; e < DPL / 2; ++e)
    o[e] = __floats2bfloat162_rn(num[2 * e] * scale, num[2 * e + 1] * scale);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* kpos,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int Sq, int S, int Hq, int Hkv, int q_offset, int window,
           float scale, int n_split, int split_slots, cudaStream_t stream) {
  using L = Layout<DH>;
  auto kernel = flash_prefill_kernel<DH>;
  const size_t smem = L::bytes((split_slots + FP_BK - 1) / FP_BK);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the attribute follows the largest launch so far
  static size_t granted = 0;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  const int G = Hq / Hkv;
  dim3 grid(ceil_div((long)Sq * G, FP_M), Hkv * n_split, B);
  kernel<<<grid, L::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)kpos, (__nv_bfloat16*)out, m_part,
      l_part, acc_part, Sq, S, Hq, Hkv, G, q_offset, window, scale, n_split,
      split_slots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const int rows = B * Sq * Hq;
  flash_prefill_combine_kernel<DH><<<ceil_div(rows, FC_WARPS), 32 * FC_WARPS, 0, stream>>>(
      m_part, l_part, acc_part, (const __nv_bfloat16*)v, (__nv_bfloat16*)out,
      rows, Sq, S, Hq, Hkv, G, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, Dh), k/v (B, S, Hkv, Dh) bf16, kpos (S,) int32 ->
// out (B, Sq, Hq, Dh) bf16.  The cache is cut into n_split splits of
// split_slots slots (a multiple of the 64-slot tile; the last one ragged);
// with n_split > 1 the splits' f32 partials go through m/l (B, Sq, Hq,
// n_split) and acc (B, Sq, Hq, n_split, Dh), and a second kernel combines
// them.  Dh is 64, 128 or 256; Hq must be a multiple of Hkv.
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  const void* kpos, void* out, void* m_part,
                                  void* l_part, void* acc_part, int B, int Sq,
                                  int S, int Hq, int Hkv, int Dh, int q_offset,
                                  int window, int n_split, int split_slots,
                                  float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (split_slots <= 0 || split_slots % FP_BK || n_split <= 0 || Sq <= 0 ||
      (long)(n_split - 1) * split_slots >= S || (long)n_split * split_slots < S)
    return (int)cudaErrorInvalidValue;
  float *m = (float*)m_part, *l = (float*)l_part, *acc = (float*)acc_part;
  if (Dh == 64)
    return launch<64>(q, k, v, kpos, out, m, l, acc, B, Sq, S, Hq, Hkv,
                      q_offset, window, scale, n_split, split_slots, st);
  if (Dh == 128)
    return launch<128>(q, k, v, kpos, out, m, l, acc, B, Sq, S, Hq, Hkv,
                       q_offset, window, scale, n_split, split_slots, st);
  if (Dh == 256)
    return launch<256>(q, k, v, kpos, out, m, l, acc, B, Sq, S, Hq, Hkv,
                       q_offset, window, scale, n_split, split_slots, st);
  return (int)cudaErrorInvalidValue;
}
