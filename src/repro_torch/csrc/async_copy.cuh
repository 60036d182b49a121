// Asynchronous copies between device and shared memory, shared by the
// port's kernels (sm_90a):
//   - cp.async: 16- or 4-byte copies a thread, completing per thread by
//     commit / wait groups, or on an mbarrier (cp_async_mbar_arrive);
//   - bulk copies (cp.async.bulk, the Tensor Memory Accelerator): one
//     thread moves a contiguous run of 16-byte multiples, or a box of a
//     tensor described by a tensor map, from device to shared memory,
//     completing on an mbarrier by bytes;
//   - mbarriers in shared memory, waited on by phase parity.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const int n = full ? 16 : 0;  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// this thread's writes to shared memory (cp.async included) seen by the
// async proxy (wgmma operands, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// after one thread's mbar_inits, before the block barrier that publishes them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// an arrival that also expects `bytes` more of bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}

// an arrival once this thread's earlier cp.async copies have landed; counts
// against the barrier's expected arrivals
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(b)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A copy that never
// lands would hang the card: after ~2^22 polls the kernel traps instead,
// and the launch fails.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}

// --- bulk copies --------------------------------------------------------------

// device -> shared, `bytes` a multiple of 16 at 16-byte aligned addresses;
// completes on `b` (which must expect the bytes)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}

// a box of a 3-D tensor map at (x, y, z) (innermost first) -> shared memory
// at a 128-byte boundary; completes on `b` with the whole box's bytes, the
// part outside the tensor filled with zeros.  `tmap` is the address of a
// __grid_constant__ CUtensorMap kernel parameter.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int x, int y,
                                            int z, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(tmap), "r"(x), "r"(y), "r"(z), "r"(smem_u32(b))
      : "memory");
}
